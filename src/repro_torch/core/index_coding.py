"""Basis-index encoding (paper Fig. 2), CSR layout, loop-free.

Per block, the set of selected PCA basis indices is a binary membership
sequence over basis positions. Because leading (large-eigenvalue) vectors are
selected far more often, the sequence typically ends in a run of zeros: we
store only the shortest prefix containing all ones, preceded by a 16-bit
length field. Blocks with no selected coefficients cost just the length field.

The in-memory representation is CSR: ``offsets`` (NB+1, int64) and ``flat``
(nnz, int64) with each block's indices ascending. Encode/decode are pure
``cumsum``/``repeat``/``searchsorted``/``packbits`` passes — no per-block
Python loop — which is what lets the guarantee engine stream millions of
blocks through this stage. The wire format is unchanged from the seed
(list-of-sets) implementation, so old blobs decode bit-identically.
"""

from __future__ import annotations

import numpy as np


def sets_to_csr(index_sets: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """List-of-ascending-index-arrays -> (offsets, flat)."""
    counts = np.array([len(ids) for ids in index_sets], dtype=np.int64)
    offsets = np.zeros(len(index_sets) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = (
        np.concatenate([np.asarray(ids, dtype=np.int64) for ids in index_sets])
        if offsets[-1]
        else np.zeros(0, np.int64)
    )
    return offsets, flat


def csr_to_sets(offsets: np.ndarray, flat: np.ndarray) -> list[np.ndarray]:
    """(offsets, flat) -> list of per-block index arrays (views where possible)."""
    return np.split(np.asarray(flat, dtype=np.int64), offsets[1:-1])


def _block_lengths(offsets: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """Shortest prefix containing all ones, per block: last index + 1.

    Indices are ascending within a block, so the block max is the element
    just before the next offset — a single gather, no reduction loop.
    """
    counts = np.diff(offsets)
    last = flat[np.maximum(offsets[1:] - 1, 0)] if flat.size else np.zeros_like(counts)
    return np.where(counts > 0, last + 1, 0)


def encode_indices(offsets: np.ndarray, flat: np.ndarray) -> bytes:
    """Pack CSR index sets into the Fig. 2 bitstream."""
    offsets = np.asarray(offsets, dtype=np.int64)
    flat = np.asarray(flat, dtype=np.int64)
    n = len(offsets) - 1
    lengths = _block_lengths(offsets, flat)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    bits = np.zeros(int(lengths.sum()), dtype=np.uint8)
    bits[flat + np.repeat(starts, np.diff(offsets))] = 1
    header = np.asarray(n, dtype="<u4").tobytes()
    return header + lengths.astype("<u2").tobytes() + np.packbits(bits).tobytes()


def decode_indices(blob: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_indices`; returns (offsets, flat).

    The payload must be exactly the ``ceil(total_bits / 8)`` bytes the
    encoder emits — a length-framed slice that is short or long means the
    framing (not just the content) is corrupt, and raises.
    """
    n = int(np.frombuffer(blob, dtype="<u4", count=1)[0])
    lengths = np.frombuffer(blob, dtype="<u2", count=n, offset=4).astype(np.int64)
    payload = np.frombuffer(blob, dtype=np.uint8, offset=4 + 2 * n)
    total = int(lengths.sum())
    if payload.size != (total + 7) // 8:
        raise ValueError(
            f"corrupt index stream: bitmap is {payload.size} bytes, "
            f"lengths declare {(total + 7) // 8}"
        )
    bits = np.unpackbits(payload, count=total) if total else np.zeros(0, np.uint8)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    pos = np.flatnonzero(bits)
    block = np.searchsorted(ends, pos, side="right")
    flat = (pos - starts[block]).astype(np.int64)
    counts = np.bincount(block, minlength=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, flat


def encoded_size_bytes(offsets: np.ndarray, flat: np.ndarray) -> int:
    offsets = np.asarray(offsets, dtype=np.int64)
    flat = np.asarray(flat, dtype=np.int64)
    total_bits = int(_block_lengths(offsets, flat).sum())
    return 4 + 2 * (len(offsets) - 1) + (total_bits + 7) // 8
