"""Guaranteed autoencoder post-process (paper Algorithm 1), device-resident.

Given original blocks ``x`` and AE reconstructions ``x_rec`` (per species,
shape (NB, D)), we bound each block's residual l2 norm by tau:

  1. PCA on the full residual matrix -> orthonormal basis U (D x D).
  2. For every block whose residual norm exceeds tau: project c = U^T r,
     sort coefficients by energy c_k^2, and keep the smallest M quantized
     coefficients such that the *corrected* residual satisfies
     ||x - (x_rec + U_s c_q)||_2 <= tau.

Because U is orthonormal, the corrected residual energy after keeping a
coefficient set S with quantized values c_q is exactly

  ||r||^2 - sum_{k in S} (2 c_k c_qk - c_qk^2),

so the greedy loop of Algorithm 1 collapses to a cumulative sum over the
energy-sorted coefficients plus a searchsorted — no per-block Python loop.

The coefficient quantization bin is clamped to 1.8*tau/sqrt(D) so that even
the degenerate all-D correction meets the bound (worst-case quantization
residual sqrt(D)*bin/2 <= 0.9*tau): the guarantee is *unconditional*.

Engine architecture
-------------------
:class:`GuaranteeEngine` splits the stage by what depends on the error
bound:

* ``prepare(x, x_rec)`` — everything tau-INDEPENDENT: the fp64 residual,
  per-block norms, the per-species PCA factorization (host numpy, so the
  basis is bit-identical to the numpy oracle's), the projection c = R @ U
  as a single batched fp64 launch of the hand-written CUDA kernel
  (``gbatc_project_batched``), and the per-block energy ordering. The
  projection, ordering, and reconstruction tensors stay device-resident.
* ``select(prepared, tau, coeff_bin)`` — the cheap per-error-bound pass:
  quantization and the gain cumsum/cut as fp64 tensor ops on the device
  feeding the masked select-and-accumulate kernel
  (``gbatc_select_accumulate``) on one stream; the host then assembles
  the CSR artifact with vectorized ``nonzero``/``cumsum`` passes.

``pipeline.compress`` sweeps error bounds against one fitted model, so the
prepare cost amortizes across the sweep.

Every kernel call goes through :mod:`repro_torch.kernels.ops`: the CUDA
kernels on a CUDA device, their plain PyTorch versions only when the
engine was built with ``device="cpu"``.

Numerical contract: quantized coefficients, index sets, and the trimmed
basis are bit-identical to the oracle's. The only reordering risk is fp64
summation-order differences (~1e-16 relative) landing exactly on a
quantization or cut boundary — probability ~1e-9 per full sweep.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core import container, entropy, index_coding, pca
from repro_torch.core.quantization import dequantize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass
class GuaranteeArtifact:
    """Everything needed to replay the correction at decode time.

    Index sets use a CSR layout — ``index_offsets`` (NB+1,) into
    ``index_flat`` (nnz,), ascending within each block — so encode/decode
    and correction replay are loop-free vectorized passes.
    """

    basis: np.ndarray  # (D, n_basis_stored) float32, leading columns of U
    coeff_q: np.ndarray  # flat int64 quantized coefficients (ascending index per block)
    index_offsets: np.ndarray  # (NB+1,) int64 CSR offsets
    index_flat: np.ndarray  # (nnz,) int64 selected basis indices
    coeff_bin: float
    tau: float
    # memoized stream sizes: byte accounting sweeps (bench_compression's
    # TARGETS loop) would otherwise recount identical Huffman streams
    _coeff_bytes: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _index_bytes: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @classmethod
    def empty(cls, nb: int, d: int, tau: float) -> "GuaranteeArtifact":
        return cls(
            basis=np.zeros((d, 0), np.float32),
            coeff_q=np.zeros(0, np.int64),
            index_offsets=np.zeros(nb + 1, np.int64),
            index_flat=np.zeros(0, np.int64),
            coeff_bin=0.0,
            tau=float(tau),
        )

    @property
    def n_blocks(self) -> int:
        return len(self.index_offsets) - 1

    @property
    def index_sets(self) -> list[np.ndarray]:
        """Per-block index arrays (list view of the CSR layout)."""
        return index_coding.csr_to_sets(self.index_offsets, self.index_flat)

    # --- exact storage accounting -------------------------------------
    def coeff_bytes(self) -> int:
        if self._coeff_bytes is None:
            self._coeff_bytes = entropy.huffman_size_bytes(self.coeff_q)
        return self._coeff_bytes

    def index_bytes(self) -> int:
        if self._index_bytes is None:
            self._index_bytes = index_coding.encoded_size_bytes(
                self.index_offsets, self.index_flat
            )
        return self._index_bytes

    def basis_bytes(self) -> int:
        return self.basis.size * 4

    def total_bytes(self) -> int:
        # 16 bytes of per-species metadata (tau, bin as float64)
        return self.coeff_bytes() + self.index_bytes() + self.basis_bytes() + 16

    # --- wire format ---------------------------------------------------
    # the per-species guarantee artifact header predates the container
    # and is parsed by from_bytes round-trips in tier-1; the container
    # only frames its bytes.
    _META = struct.Struct("<ddII")  # repro: allow[wire-centralization]

    def wire_parts(self) -> tuple[bytes, bytes, bytes]:
        """The (coeff, index, basis) payload streams — the single encode
        site shared by the v1 nested container (:meth:`to_bytes`) and the
        v2 combined guarantee stream (``repro_torch.codec``)."""
        return (
            entropy.huffman_encode(self.coeff_q),
            index_coding.encode_indices(self.index_offsets, self.index_flat),
            np.ascontiguousarray(
                self.basis.astype("<f4", copy=False)).tobytes(),
        )

    def to_bytes(self) -> bytes:
        """Serialize to a nested container: coeff (Huffman), index (Fig. 2
        bitmap), basis (raw little-endian float32), meta (tau/bin/dims) —
        the container-v1 per-species layout, byte-stable across PRs."""
        coeff, index, basis = self.wire_parts()
        w = container.ContainerWriter()
        w.add("coeff", coeff)
        w.add("index", index)
        w.add("basis", basis)
        w.add("meta", self._META.pack(self.tau, self.coeff_bin,
                                      *self.basis.shape))
        return w.to_bytes()

    @classmethod
    def from_bytes(
        cls,
        blob: bytes,
        *,
        table_cache: Optional[entropy.DecodeTableCache] = None,
        huffman=None,
    ) -> "GuaranteeArtifact":
        """Inverse of :func:`to_bytes`; raises ContainerFormatError on a
        malformed blob. Stream-size memos are seeded from the measured
        payload lengths (they are exact by construction).

        ``table_cache`` memoizes Huffman decode tables across calls sharing
        a codebook; ``huffman`` overrides the coefficient decoder (the
        codec benchmark passes :func:`entropy.huffman_decode_ref` to time
        the retained pre-change deserialize path)."""
        r = container.ContainerReader(blob)
        meta = r["meta"]
        if len(meta) != cls._META.size:
            raise container.ContainerFormatError(
                f"guarantee meta stream is {len(meta)} bytes, "
                f"expected {cls._META.size}"
            )
        tau, coeff_bin, d, n_store = cls._META.unpack(meta)
        return cls.from_parts(
            tau, coeff_bin, d, n_store, r["coeff"], r["index"], r["basis"],
            table_cache=table_cache, huffman=huffman,
        )

    @classmethod
    def from_parts(
        cls,
        tau: float,
        coeff_bin: float,
        d: int,
        n_store: int,
        coeff_stream: bytes,
        index_stream: bytes,
        raw_basis: bytes,
        *,
        table_cache: Optional[entropy.DecodeTableCache] = None,
        huffman=None,
        coeff_q: Optional[np.ndarray] = None,
    ) -> "GuaranteeArtifact":
        """Assemble + validate an artifact from its wire streams.

        The single decode/validation site behind :meth:`from_bytes` (v1
        nested containers) and the codec's v2 combined guarantee stream —
        a malformed stream raises :class:`ContainerFormatError` here no
        matter which framing delivered it. ``coeff_q`` supplies
        pre-decoded coefficient symbols (the batched lockstep decode path)
        and skips the per-stream Huffman walk."""
        if huffman is None:
            huffman = entropy.huffman_decode
        if not (np.isfinite(tau) and tau >= 0):
            raise container.ContainerFormatError(f"bad tau {tau!r}")
        if not (np.isfinite(coeff_bin) and coeff_bin >= 0):
            raise container.ContainerFormatError(f"bad coeff bin {coeff_bin!r}")
        if len(raw_basis) != 4 * d * n_store:
            raise container.ContainerFormatError(
                f"basis stream is {len(raw_basis)} bytes, "
                f"expected {4 * d * n_store} for shape ({d}, {n_store})"
            )
        basis = np.frombuffer(raw_basis, dtype="<f4").reshape(d, n_store)
        try:
            if coeff_q is None:
                if huffman is entropy.huffman_decode:
                    coeff_q = huffman(coeff_stream, table_cache=table_cache)
                else:
                    coeff_q = huffman(coeff_stream)
            offsets, flat = index_coding.decode_indices(index_stream)
        except (ValueError, struct.error) as e:
            # struct.error: truncated Huffman/index headers (not a ValueError)
            raise container.ContainerFormatError(
                f"corrupt guarantee stream: {e}"
            ) from e
        if coeff_q.size != flat.size:
            raise container.ContainerFormatError(
                f"coefficient stream ({coeff_q.size}) and index stream "
                f"({flat.size}) disagree on selection count"
            )
        if coeff_q.size and coeff_bin == 0.0:
            raise container.ContainerFormatError(
                "zero coefficient bin with a non-empty coefficient stream"
            )
        if n_store > d:
            raise container.ContainerFormatError(
                f"basis claims {n_store} stored columns for dimension {d}"
            )
        if flat.size and (flat.min() < 0 or flat.max() >= n_store):
            # a well-framed but bit-flipped index payload must not scatter
            # coefficients into absent basis columns at replay time
            raise container.ContainerFormatError(
                f"index stream selects basis column "
                f"{int(flat.max() if flat.size else 0)} but only "
                f"{n_store} columns are stored"
            )
        return cls(
            basis=basis.astype(np.float32),
            coeff_q=coeff_q,
            index_offsets=offsets,
            index_flat=flat,
            coeff_bin=float(coeff_bin),
            tau=float(tau),
            _coeff_bytes=len(coeff_stream),
            _index_bytes=len(index_stream),
        )


def _effective_bin(coeff_bin: float, tau: float, d: int) -> float:
    cap = 1.8 * tau / np.sqrt(d)
    return float(min(coeff_bin, cap)) if coeff_bin > 0 else float(cap)


_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    """Shared worker pool for per-species numpy stages.

    Every parallelized stage writes disjoint per-species slices with pure
    per-slice arithmetic, so results are bitwise independent of scheduling.
    numpy releases the GIL, and on memory-bound elementwise chains the
    per-species split also improves cache residency.
    """
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=min(os.cpu_count() or 1, 8))
    return _POOL


def _stable_desc_order(energy: np.ndarray) -> np.ndarray:
    """Stable argsort of ``-energy`` along the last axis, introsort-fast.

    ``np.argsort(kind="stable")`` on fp64 is a mergesort and ~2x slower than
    introsort. Rows without duplicate keys sort identically under any
    correct comparison sort, so run the fast unstable sort everywhere and
    re-sort only the (rare) rows that actually contain ties.
    """
    neg = -energy
    order = np.argsort(neg, axis=-1)
    sorted_vals = np.take_along_axis(neg, order, axis=-1)
    ties = (sorted_vals[..., 1:] == sorted_vals[..., :-1]).any(axis=-1)
    if ties.any():
        rows = np.nonzero(ties)
        order[rows] = np.argsort(neg[rows], axis=-1, kind="stable")
    return order.astype(np.int32)


@dataclasses.dataclass
class PreparedGuarantee:
    """Tau-independent guarantee state (see GuaranteeEngine.prepare)."""

    shape: tuple[int, int, int]  # (S, NB, D)
    x_ref: np.ndarray  # the originals this state was computed against
    x_rec32: np.ndarray  # (S, NB, D) float32 host copy (fast no-fix path)
    norms2: np.ndarray  # (S, NB) float64 residual energies (host)
    basis: np.ndarray  # (S, D, D) float64 PCA bases (host, oracle-bitwise)
    inv_rank: np.ndarray  # (S, NB, D) int32 energy rank of each element (host)
    coeffs: np.ndarray  # (S, NB, D) float64 projections (host mirror)
    coeffs_sorted: np.ndarray  # (S, NB, D) float64, energy-descending per block
    # device-resident tensors (None when a backend never reads them)
    coeffs_dev: object  # (S, NB, D) float64 projections (device selection backend)
    coeffs_sorted_dev: object  # (S, NB, D) float64 (device selection backend)
    inv_rank_dev: object  # (S, NB, D) int32 rank of each element
    norms2_dev: object  # (S, NB) float64
    x_rec_dev: object  # (S, NB, D) float32
    basis32_dev: object  # (S, D, D) float32


class GuaranteeEngine:
    """Batched-over-species, device-resident Algorithm 1.

    ``device=None`` means the GPU (and raises without CUDA); the engine's
    three products then run as the hand-written CUDA kernels. With
    ``device="cpu"`` they run as their plain PyTorch versions.

    ``select_backend`` picks where the coefficient-selection math (the
    quantized-gain cumsum and its first crossing) runs:

    * ``"device"`` — fp64 tensor ops on the engine's device, feeding the
      select-and-accumulate kernel on the same stream with no host sync in
      between (the default on CUDA);
    * ``"host"`` — the same arithmetic in numpy, expression for expression
      the numpy oracle's, so the cumulative gains are bit-identical to it
      rather than identical-up-to-scan-order (the default on the CPU).

    Both backends call the kernels for the projection and the
    masked-correction products, and both produce oracle-bit-identical
    artifacts.
    """

    def __init__(self, device: DeviceLike = None,
                 select_backend: Optional[str] = None):
        self.device = resolve_device(device)
        if select_backend is None:
            select_backend = "device" if self.device.type == "cuda" else "host"
        if select_backend not in ("host", "device"):
            raise ValueError(f"unknown select_backend {select_backend!r}")
        self.select_backend = select_backend
        #: seconds of the last ``prepare``'s stages (host PCA, projection
        #: launch + wait, device->host copy of the projection, ordering)
        self.last_prepare_s: dict = {}

    # -- batched programs ------------------------------------------------
    # each runs on the device of its staged operands: the engine's device
    # here, a chunk's device under a sharded engine's _dispatch
    def _project(self, residual, basis):
        return ops.gbatc_project_batched(residual, basis, device=residual.device)

    def _apply(self, x_rec, dense, basis):
        return ops.gbatc_correct_batched(x_rec, dense, basis,
                                         device=x_rec.device)

    def _correct(self, x_rec, cqv32, inv_rank, m_eff, basis32):
        return ops.gbatc_select_accumulate(
            x_rec, cqv32, inv_rank, m_eff, basis32, device=x_rec.device
        )

    def _select(self, coeffs, coeffs_sorted, inv_rank, norms2, x_rec,
                basis32, tau2, bin_size):
        # gains in energy-descending order (the sort itself is
        # tau-independent and lives in prepare); gains are >= 0, so the
        # first cumsum crossing IS the oracle's running-max crossing.
        # torch.round is round-half-to-even, like rint.
        cqv_s = torch.round(coeffs_sorted / bin_size).mul_(bin_size)
        gain = (2.0 * coeffs_sorted).mul_(cqv_s).sub_(cqv_s * cqv_s)
        del cqv_s
        cum = torch.cumsum(gain, dim=2)
        del gain
        target = norms2 - tau2
        needs = norms2 > tau2
        m = 1 + torch.argmax((cum >= target[..., None]).to(torch.uint8), dim=2)
        achieved = torch.gather(cum, 2, (m - 1)[..., None])[..., 0]
        del cum
        m_eff = torch.where(needs, m, torch.zeros_like(m)).to(torch.int32)
        cq = torch.round(coeffs / bin_size)  # index-ordered ints (as f64)
        corrected = self._correct(
            x_rec, (cq * bin_size).to(torch.float32), inv_rank, m_eff, basis32
        )
        return corrected, cq, m_eff, achieved

    # -- dispatch/staging seams (subclass points for sharded engines) ----
    def _stage(self, arr):
        """Stage a prepared tensor for kernel dispatch. The default engine
        keeps prepared tensors device-resident; a sharded engine can keep
        them on host and chunk-upload per dispatch instead."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _dispatch(self, kernel: str, *args):
        """Run one batched program (``project`` / ``select`` / ``correct``
        / ``apply``). The default engine makes the single batched call; a
        sharded engine can split the batch over species and block rows —
        the kernels are per-species and per-block-row pure, so the
        concatenated results are bitwise the batched ones."""
        return getattr(self, f"_{kernel}")(*args)

    # -- tau-independent stage -----------------------------------------
    def prepare(
        self,
        x: np.ndarray,
        x_rec: np.ndarray,
        reuse: Optional[PreparedGuarantee] = None,
    ) -> PreparedGuarantee:
        """Factor out everything that does not depend on the error bound.

        ``reuse`` starts the ROADMAP's shared-residual incremental prepare:
        given a previous :class:`PreparedGuarantee` over the *same original
        vectors* ``x``, any species whose reconstruction is bitwise
        unchanged reuses its residual norms, PCA basis, projection, and
        energy ordering wholesale; only changed species recompute. The
        recomputed slices go through the same batched gram/eigh/projection
        /sort path as a cold prepare (per-species arithmetic is slice-pure),
        so the result is bit-identical to a cold ``prepare(x, x_rec)`` —
        asserted by the parity suite. Reuse is keyed on values, not
        provenance: a stale ``reuse`` from different ``x`` is rejected by
        the caller contract (pipeline passes its one fitted ``vecs_orig``).
        """
        x = np.asarray(x)
        x_rec32 = np.asarray(x_rec, dtype=np.float32)
        s, nb, d = x.shape

        stale = np.arange(s)
        # staleness is judged on the f32 mirror, which is only sound when
        # the reconstruction IS f32 (the pipeline's case); a float64 x_rec
        # could differ below f32 precision, so it never reuses. The
        # originals must also be the ones the reuse state was computed
        # against — identity for the common case, value equality otherwise
        can_reuse = (
            reuse is not None
            and reuse.shape == (s, nb, d)
            and np.asarray(x_rec).dtype == np.float32
            and (reuse.x_ref is x or np.array_equal(reuse.x_ref, x))
        )
        if can_reuse:
            stale = np.array(
                [
                    sidx
                    for sidx in range(s)
                    if not np.array_equal(x_rec32[sidx], reuse.x_rec32[sidx])
                ],
                dtype=np.int64,
            )
            if len(stale) == 0:
                return reuse

        # residual in the caller's precision (matches the oracle's
        # float64 contract even for float64 reconstructions); only the
        # correction kernel input and fast-path output are float32
        full = len(stale) == s
        x_rec_arr = np.asarray(x_rec)
        residual = (x if full else x[stale]).astype(np.float64)
        residual -= (x_rec_arr if full else x_rec_arr[stale]).astype(np.float64)
        norms2_stale = np.sum(residual**2, axis=2)
        # PCA on host numpy: the D x D eigh is tiny, and sharing the exact
        # gram/eigh path with the numpy oracle is what makes the engine's
        # byte accounting bit-identical to it.
        t0 = time.perf_counter()
        basis_stale, _ = pca.pca_basis_stack(residual, executor=_pool())
        t1 = time.perf_counter()

        residual_dev = self._stage(residual)
        basis_dev = self._stage(basis_stale)
        coeffs_stale_dev = self._dispatch("project", residual_dev, basis_dev)
        del residual_dev, basis_dev, residual
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        # host ordering and CSR assembly need the projection on the host:
        # one device->host copy of S*NB*D fp64
        coeffs_stale = coeffs_stale_dev.cpu().numpy()
        t3 = time.perf_counter()

        if not can_reuse or len(stale) == s:
            norms2, basis, coeffs = norms2_stale, basis_stale, coeffs_stale
            coeffs_sorted = np.empty_like(coeffs)
            inv_rank = np.empty((s, nb, d), np.int32)
            fresh = range(s)
        else:
            norms2 = reuse.norms2.copy()
            norms2[stale] = norms2_stale
            basis = reuse.basis.copy()
            basis[stale] = basis_stale
            coeffs = reuse.coeffs.copy()
            coeffs[stale] = coeffs_stale
            coeffs_sorted = reuse.coeffs_sorted.copy()
            inv_rank = reuse.inv_rank.copy()
            fresh = stale.tolist()

        iota = np.arange(d, dtype=np.int32)

        def order_work(sidx):
            order = _stable_desc_order(coeffs[sidx] ** 2)
            coeffs_sorted[sidx] = np.take_along_axis(coeffs[sidx], order, axis=-1)
            np.put_along_axis(
                inv_rank[sidx], order, np.broadcast_to(iota, order.shape), axis=-1
            )

        list(_pool().map(order_work, fresh))
        self.last_prepare_s = {
            "pca": t1 - t0, "project": t2 - t1, "coeffs_to_host": t3 - t2,
            "order": time.perf_counter() - t3,
        }
        device_backend = self.select_backend == "device"
        full_recompute = coeffs is coeffs_stale
        prepared = PreparedGuarantee(
            shape=(s, nb, d),
            x_ref=x,
            x_rec32=x_rec32,
            norms2=norms2,
            basis=basis,
            inv_rank=inv_rank,
            coeffs=coeffs,
            coeffs_sorted=coeffs_sorted,
            # the host backend reads the host mirror only; keeping the
            # device projection alive would pin S*NB*D fp64 for nothing.
            # On a full recompute the projection is already device
            # resident — re-uploading the host copy would waste a
            # S*NB*D fp64 transfer on the accelerator path
            coeffs_dev=(
                (coeffs_stale_dev if full_recompute
                 else self._stage(coeffs))
                if device_backend else None
            ),
            coeffs_sorted_dev=(
                self._stage(coeffs_sorted) if device_backend else None
            ),
            inv_rank_dev=self._stage(inv_rank),
            norms2_dev=self._stage(norms2) if device_backend else None,
            x_rec_dev=self._stage(x_rec32),
            basis32_dev=self._stage(basis.astype(np.float32)),
        )
        return prepared

    # -- per-error-bound stage -----------------------------------------
    def select(
        self,
        prep: PreparedGuarantee,
        tau: float,
        coeff_bin: float = 0.0,
    ) -> tuple[np.ndarray, list[GuaranteeArtifact]]:
        """Apply Algorithm 1 at one error bound; returns (corrected, artifacts)."""
        s, nb, d = prep.shape
        tau = float(tau)
        tau2 = tau * tau
        needs = prep.norms2 > tau2
        if not needs.any():
            arts = [GuaranteeArtifact.empty(nb, d, tau) for _ in range(s)]
            return prep.x_rec32.astype(np.float32), arts

        bin_size = _effective_bin(coeff_bin, tau, d)
        if self.select_backend == "host":
            corrected, cq, m_eff, achieved = self._select_host(
                prep, needs, tau2, bin_size
            )
        else:
            if prep.coeffs_dev is None:
                raise ValueError(
                    "prepared state was built by a host-select engine and "
                    "holds no device projection; select with that engine"
                )
            corrected, cq, m_eff, achieved = self._dispatch(
                "select",
                prep.coeffs_dev,
                prep.coeffs_sorted_dev,
                prep.inv_rank_dev,
                prep.norms2_dev,
                prep.x_rec_dev,
                prep.basis32_dev,
                float(tau2),
                float(bin_size),
            )
            corrected = corrected.cpu().numpy()
            cq = cq.cpu().numpy()
            m_eff = m_eff.cpu().numpy()
            achieved = achieved.cpu().numpy()

        # Guaranteed by bin clamp, but assert rather than assume:
        target = prep.norms2 - tau2
        slack = 1e-9 * np.maximum(prep.norms2, 1.0)
        if not np.all(achieved[needs] >= (target - slack)[needs]):
            raise AssertionError("guarantee violated — coefficient bin clamp failed")

        arts = self._build_artifacts(prep, m_eff, cq, needs, bin_size, tau)
        return corrected, arts

    def _select_host(self, prep, needs, tau2, bin_size):
        """Host-numpy selection math + masked-correction kernel dispatch.

        Arithmetic mirrors the oracle expression for expression, so the
        cumulative gains — and therefore the cut — are bit-identical to it,
        not merely scan-order-close. Species are processed by the shared
        thread pool (disjoint slices, pure per-slice ops).
        """
        s, nb, d = prep.shape
        m_eff = np.empty((s, nb), np.int32)
        achieved = np.empty((s, nb), np.float64)
        cq = np.empty((s, nb, d), np.float64)
        cqv32 = np.empty((s, nb, d), np.float32)
        # row-chunked tasks: every op is row-independent, and ~1k-row
        # slices keep the ~10-pass working set L2-resident
        chunk = max(256, min(nb, 1024))

        def work(task):
            sidx, r0 = task
            r1 = min(r0 + chunk, nb)
            rows = slice(r0, r1)
            cs = prep.coeffs_sorted[sidx, rows]
            # in-place where bit-exactness allows: 2*(c*cqv) == (2*c)*cqv
            # exactly (scaling by 2 is exponent-only), so the gains match
            # the oracle's `2.0 * coeffs * cq - cq**2` bit for bit
            cqv = cs / bin_size
            np.rint(cqv, out=cqv)
            cqv *= bin_size  # the dequantized values, exactly oracle's cq
            gain = cs * cqv
            gain *= 2.0
            cqv *= cqv
            gain -= cqv
            cum = np.cumsum(gain, axis=-1, out=gain)
            target = prep.norms2[sidx, rows] - tau2
            # gains are >= 0: the first plain-cumsum crossing IS the
            # oracle's running-max crossing (the max is redundant there)
            m = 1 + np.argmax(cum >= target[:, None], axis=-1)
            achieved[sidx, rows] = np.take_along_axis(
                cum, (m - 1)[:, None], axis=-1
            )[:, 0]
            m_eff[sidx, rows] = np.where(needs[sidx, rows], m, 0)
            np.divide(prep.coeffs[sidx, rows], bin_size, out=cq[sidx, rows])
            np.rint(cq[sidx, rows], out=cq[sidx, rows])
            # (int * bin) in f64, then cast on store — must match the
            # decode path's dequantize(...).astype(f32) bit for bit
            np.multiply(cq[sidx, rows], bin_size, out=cum)
            cqv32[sidx, rows] = cum

        tasks = [(sidx, r0) for sidx in range(s) for r0 in range(0, nb, chunk)]
        list(_pool().map(work, tasks))
        corrected = self._dispatch(
            "correct",
            prep.x_rec_dev, self._stage(cqv32), prep.inv_rank_dev,
            self._stage(m_eff), prep.basis32_dev,
        ).cpu().numpy()
        return corrected, cq, m_eff, achieved

    @staticmethod
    def _build_artifacts(prep, m_eff, cq, needs, bin_size, tau):
        """CSR artifact assembly: one flatnonzero pass per species, no
        per-block loops; species run on the shared thread pool."""
        s, nb, d = prep.shape

        def work(sidx):
            if not needs[sidx].any():
                return GuaranteeArtifact.empty(nb, d, tau)
            keep = prep.inv_rank[sidx] < m_eff[sidx][:, None]
            flat_idx = np.flatnonzero(keep)
            flat = flat_idx % d
            # cq holds exact integers as float64 (rint output) — exact cast
            coeff_q = cq[sidx].reshape(-1)[flat_idx].astype(np.int64)
            offsets = np.zeros(nb + 1, np.int64)
            np.cumsum(keep.sum(axis=1, dtype=np.int64), out=offsets[1:])
            n_store = int(flat.max()) + 1 if flat.size else 0
            return GuaranteeArtifact(
                basis=prep.basis[sidx][:, :n_store].astype(np.float32),
                coeff_q=coeff_q,
                index_offsets=offsets,
                index_flat=flat,
                coeff_bin=bin_size,
                tau=tau,
            )

        return list(_pool().map(work, range(s)))

    # -- decode path ----------------------------------------------------
    def dense_corrections(
        self,
        arts: list[GuaranteeArtifact],
        shape: tuple[int, int, int],
        block_range: Optional[tuple[int, int]] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Scatter CSR artifacts into the kernel inputs (dense, basis_pad).

        Per-species flat scatter: CSR row ids come from one repeat over the
        per-block counts; species slices are disjoint (thread pool). Host
        work only — callers overlap it with in-flight device decode.

        ``block_range=(b0, b1)`` scatters only that window of block rows
        (``shape[1] == b1 - b0``): the CSR offsets address the window's
        coefficient/index spans directly, so the cost scales with the
        window's selection count, not the artifact's. Values are sliced
        from the same streams the full scatter reads — per-element
        arithmetic, hence bitwise equal to slicing a full scatter.
        """
        s, nb, d = shape
        b0, b1 = (0, nb) if block_range is None else block_range
        dense = np.zeros((s, nb, d), np.float32)
        basis_pad = np.zeros((s, d, d), np.float32)

        def work(sidx):
            art = arts[sidx]
            if art.coeff_q.size == 0:
                return
            off = art.index_offsets
            lo, hi = int(off[b0]), int(off[b1])
            if hi > lo:
                rows = np.repeat(
                    np.arange(nb, dtype=np.int64), np.diff(off[b0 : b1 + 1])
                )
                dense[sidx].reshape(-1)[
                    rows * d + art.index_flat[lo:hi]
                ] = dequantize(
                    art.coeff_q[lo:hi], art.coeff_bin
                ).astype(np.float32)
            basis_pad[sidx, :, : art.basis.shape[1]] = art.basis

        list(_pool().map(work, range(s)))
        return dense, basis_pad

    def apply_device(self, x_rec_dev, dense, basis):
        """Replay on device-resident reconstructions without a host sync;
        ``dense``/``basis`` may be host arrays (staged here) or tensors."""
        return self._dispatch(
            "apply", x_rec_dev, self._stage(dense), self._stage(basis)
        )

    def apply_batched(
        self, x_rec: np.ndarray, arts: list[GuaranteeArtifact]
    ) -> np.ndarray:
        """Replay stored corrections for all species in one dispatch."""
        x_rec = np.asarray(x_rec, dtype=np.float32)
        if all(art.coeff_q.size == 0 for art in arts):
            return x_rec.copy()
        dense, basis_pad = self.dense_corrections(arts, x_rec.shape)
        out = self._dispatch(
            "apply",
            self._stage(x_rec), self._stage(dense), self._stage(basis_pad),
        )
        return out.cpu().numpy()


_DEFAULT_ENGINES: dict[str, GuaranteeEngine] = {}


def default_engine(device: DeviceLike = None) -> GuaranteeEngine:
    """The shared engine of a device (``None``: the GPU, raises without
    CUDA)."""
    dev = resolve_device(device)
    engine = _DEFAULT_ENGINES.get(str(dev))
    if engine is None:
        engine = _DEFAULT_ENGINES[str(dev)] = GuaranteeEngine(dev)
    return engine


def guarantee_batched(
    x: np.ndarray,
    x_rec: np.ndarray,
    tau: float,
    coeff_bin: float = 0.0,
    engine: Optional[GuaranteeEngine] = None,
    prepared: Optional[PreparedGuarantee] = None,
    device: DeviceLike = None,
) -> tuple[np.ndarray, list[GuaranteeArtifact]]:
    """Batched-over-species guarantee: x, x_rec are (S, NB, D)."""
    engine = engine or default_engine(device)
    if prepared is None:
        prepared = engine.prepare(x, x_rec)
    return engine.select(prepared, tau, coeff_bin)


def guarantee(
    x: np.ndarray,
    x_rec: np.ndarray,
    tau: float,
    coeff_bin: float = 0.0,
    device: DeviceLike = None,
) -> tuple[np.ndarray, GuaranteeArtifact]:
    """Correct ``x_rec`` so every block satisfies ||x - out||_2 <= tau.

    x, x_rec: (NB, D). Returns (corrected, artifact). Single-species
    convenience over :func:`guarantee_batched`.
    """
    corrected, arts = guarantee_batched(
        np.asarray(x)[None], np.asarray(x_rec)[None], tau, coeff_bin,
        device=device,
    )
    return corrected[0], arts[0]


def apply_correction(x_rec: np.ndarray, art: GuaranteeArtifact) -> np.ndarray:
    """Decode path: replay the stored correction, loop-free.

    Scatters the dequantized coefficient stream into a dense (NB, n_store)
    matrix (CSR row ids come from one ``repeat`` over the offsets) and
    applies the correction as a single GEMM.
    """
    out = np.asarray(x_rec, dtype=np.float64).copy()
    if art.coeff_q.size:
        nb = out.shape[0]
        n_store = art.basis.shape[1]
        dense = np.zeros((nb, n_store), np.float64)
        rows = np.repeat(np.arange(nb), np.diff(art.index_offsets))
        dense[rows, art.index_flat] = dequantize(art.coeff_q, art.coeff_bin)
        out += dense @ art.basis.astype(np.float64).T
    return out.astype(np.float32)


def apply_correction_batched(
    x_rec: np.ndarray,
    arts: list[GuaranteeArtifact],
    engine: Optional[GuaranteeEngine] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Batched decode replay via the correction kernel."""
    engine = engine or default_engine(device)
    return engine.apply_batched(x_rec, arts)


def verify_guarantee(x: np.ndarray, corrected: np.ndarray, tau: float) -> bool:
    """True iff every block meets the l2 bound (with fp32 round-off slack)."""
    r = np.asarray(x, np.float64) - np.asarray(corrected, np.float64)
    norms = np.sqrt(np.sum(r**2, axis=1))
    scale = np.sqrt(np.sum(np.asarray(x, np.float64) ** 2, axis=1))
    slack = 1e-5 * np.maximum(scale, 1.0)  # fp32 storage round-off
    return bool(np.all(norms <= tau + slack))
