"""End-to-end GBA / GBATC compression pipeline (paper §II, Fig. 3).

Workflow (matches the paper's):

  pipe = GBATCPipeline(cfg, n_species=S)
  pipe.fit(data)                       # train AE (+ correction net) ONCE
  rep = pipe.compress(target_nrmse=1e-3, latent_bin_rel=0.05)   # cheap sweep
  rec = pipe.decompress(rep.artifact)  # streams-only replay

Stages:
  1. per-species min/max normalization (species span ~7 decades; the NRMSE
     metric is range-normalized, so the guarantee runs in normalized units);
  2. spatiotemporal blocking (paper geometry 4 x 5 x 4);
  3. 3D-conv block AE; latents quantized + Huffman'd (the decoder consumes
     the *quantized* latents so encode/decode stay consistent);
  4. (GBATC) pointwise tensor-correction network on reconstructed->original
     species vectors;
  5. device-resident guarantee engine (Algorithm 1): one batched (S, NB, D)
     dispatch through ``gae.GuaranteeEngine`` — the hand-written CUDA
     projection and masked select-and-accumulate kernels plus fp64
     selection on the device — with tau_s = target_nrmse * sqrt(D)
     (normalized range = 1). The engine's tau-independent state (residual
     PCA, projections, energy ordering) is cached per (latent_bin,
     correction) so sweeping error bounds against one fitted model pays it
     once; decompress replays corrections through the batched correction
     kernel;
  6. serialization through :mod:`repro_torch.codec`: ``artifact.to_bytes()``
     emits container v5 and ``byte_breakdown`` is a view over the
     container's *measured* stream lengths — ``breakdown["total"] ==
     len(blob)`` exactly, no estimates.

This class is the fit/orchestration layer; the wire format and the
standalone decode path live in :mod:`repro_torch.codec`. Every decode —
including the one feeding the guarantee prep — goes through the codec's
shared fused runtime, so the reconstruction the guarantee is computed
against is bit-identical to the one ``codec.decompress`` replays on the
same device.

``device=None`` means the GPU and raises without CUDA; ``device="cpu"``
runs everything, the kernels' plain versions included, on the CPU.

``mesh=`` (a :class:`~repro_torch.parallel.Mesh`) is the reference's
mesh-sharded orchestration: the block rows are split over the mesh's
devices, the AE and correction fits run data-parallel over them
(:mod:`repro_torch.parallel.mesh_fit`), ``fit_stream`` lands its chunks
in a :class:`~repro_torch.parallel.mesh_fit.ShardedBlockStore`, and
compress runs through a
:class:`~repro_torch.parallel.mesh_fit.ShardedGuaranteeEngine`. On a
1-device mesh the container is the one-device path's byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import time

import numpy as np
import torch

from repro_torch import convert, parallel
from repro_torch.codec.artifact import CompressedArtifact
from repro_torch.codec.families import get as _family, structural as _structural
from repro_torch.core import blocking, correction, gae, metrics
from repro_torch.core.quantization import dequantize, quantize, quantize_params
from repro_torch.device import DeviceLike, resolve_device, strict_fp32
from repro_torch.train.fault_tolerance import retry_with_backoff


_ENCODE_BATCH = 512  # blocks per encoder launch (bounds activation memory)


def _mesh_device(device: DeviceLike, mesh) -> torch.device:
    """The pipeline's device: ``device``, or on a mesh its first device
    (``device``, if given, must be that one)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.devices[0]}")
    return mesh.devices[0]


def _host_alloc(shape, dtype):
    """Host allocation seam for the streaming ingest buffer (tests hook it
    to see the block array ``fit_stream`` fills)."""
    return np.empty(shape, dtype)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    geometry: blocking.BlockGeometry = blocking.PAPER_GEOMETRY
    latent: int = 36
    conv_channels: tuple[int, ...] = (32, 64)
    use_correction: bool = True  # GBATC if True, GBA if False
    ae_steps: int = 600
    corr_steps: int = 300
    batch_size: int = 64
    lr: float = 2e-3
    seed: int = 0
    # paper stores networks fp32; fp16 halves the fixed overhead with
    # negligible NRMSE impact (beyond-paper option, default off)
    param_dtype_bytes: int = 4
    # encoder family (see repro_torch.codec.families): "conv" is the
    # paper's block autoencoder, "attention" the patch-token block
    # attention AE. ``arch`` carries the family's wire arch words — for
    # conv it defaults to ``conv_channels`` (kept as the historical
    # spelling), for attention to (d_model, n_heads, depth, mlp_hidden)
    # = (32, 2, 1, 64)
    family: str = "conv"
    arch: Optional[tuple[int, ...]] = None


@dataclasses.dataclass
class CompressionReport:
    recon: np.ndarray
    compression_ratio: float
    mean_nrmse: float
    per_species_nrmse: np.ndarray
    bytes_breakdown: dict
    artifact: CompressedArtifact


class GBATCPipeline:
    """GBATC when cfg.use_correction else GBA.

    Model-shaped decisions dispatch through the encoder-family registry
    (:mod:`repro_torch.codec.families`): ``cfg.family`` picks the handle, the
    normalized :class:`~repro_torch.codec.families.StructuralConfig` builds the
    model, and ``family.fit`` trains it — conv by default, so existing
    configs behave exactly as before. ``mesh`` shards the fit and compress
    over its devices (see the module docstring).
    """

    def __init__(self, cfg: PipelineConfig, n_species: int,
                 device: DeviceLike = None, mesh=None):
        self.cfg = cfg
        self.n_species = n_species
        self.mesh = mesh
        self.device = _mesh_device(device, mesh)
        self.family = _family(cfg.family)
        self.scfg = _structural(cfg)
        self.model = self.family.build_model(self.scfg, n_species, self.device)
        self.corr_net = (
            correction.TensorCorrectionNetwork(
                correction.CorrectionConfig(n_species=n_species),
                device=self.device,
            )
            if cfg.use_correction
            else None
        )
        if mesh is not None:
            from repro_torch.parallel.mesh_fit import ShardedGuaranteeEngine

            self._gengine = ShardedGuaranteeEngine(mesh=mesh)
        else:
            self._gengine = gae.default_engine(self.device)
        #: wall seconds of the stages of the last fit / compress (device
        #: work included: each stage ends on a host fetch)
        self.timings: dict = {}
        # populated by fit()
        self._ae_params: Any = None
        self._corr_params: Any = None
        self._latents: Optional[np.ndarray] = None
        self._vecs_orig: Optional[np.ndarray] = None
        # a mesh fit's block row shards, until the first compress copies
        # them to the host as _vecs_orig
        self._block_shards: Optional[list] = None
        self._data: Optional[np.ndarray] = None
        self._shape: Optional[tuple[int, int, int, int]] = None
        self._data_nbytes: int = 0
        self._norm: Optional[tuple[np.ndarray, np.ndarray]] = None
        # tau-independent guarantee state per (latent_bin, skip_correction)
        self._prepared: dict[tuple, tuple] = {}
        # most recent PreparedGuarantee — seed for the engine's
        # shared-residual incremental prepare on the next sweep key
        self._last_prepared: Optional[gae.PreparedGuarantee] = None
        # packed (decoder, correction) wire streams, constant per fit
        self._packed_params: Optional[tuple] = None

    _PREPARED_CACHE_MAX = 4  # GBATC + GBA at a couple of latent bins

    def set_guarantee_engine(self, engine) -> None:
        """Swap the guarantee engine (e.g. one with another selection
        backend). Clears the tau-independent prepared cache: prepared
        tensors are staged per engine, so prepared state never crosses
        engines."""
        self._gengine = engine
        self._prepared.clear()
        self._last_prepared = None

    # ------------------------------------------------------------------
    @staticmethod
    def _normalize(data: np.ndarray):
        mn = data.min(axis=(1, 2, 3))
        mx = data.max(axis=(1, 2, 3))
        rng = np.maximum(mx - mn, 1e-30)
        normed = (data - mn[:, None, None, None]) / rng[:, None, None, None]
        return normed.astype(np.float32), mn.astype(np.float32), rng.astype(np.float32)

    def fit(self, data: np.ndarray, verbose: bool = False) -> dict:
        """Train the AE (and correction net) once; returns training stats."""
        assert data.shape[0] == self.n_species
        t0 = time.perf_counter()
        normed, mn, rngs = self._normalize(data)
        blocks = blocking.to_blocks(normed, self.cfg.geometry)
        del normed
        if self.mesh is not None:
            blocks = parallel.shard_rows(blocks, self.mesh)
        t_blocks = time.perf_counter() - t0
        stats = self._fit_blocks(
            blocks, mn, rngs, shape=tuple(data.shape),
            data_nbytes=data.nbytes, data=data, verbose=verbose,
        )
        self.timings["normalize_block"] = t_blocks
        self.timings["fit_total"] = time.perf_counter() - t0
        return stats

    def fit_stream(self, loader, verbose: bool = False, *,
                   loader_retries: int = 2, retry_backoff: float = 0.1,
                   _sleep=None) -> dict:
        """Train from time-chunked input without materializing the field.

        ``loader`` exposes a re-iterable ``chunks()`` yielding consecutive
        (S, Tc, H, W) time chunks, each Tc divisible by the geometry's
        ``bt`` so per-chunk blocks concatenate into the canonical
        time-major block order. Two passes: per-species running min/max
        (exact: min/max commute with chunking), then normalize and block
        each chunk into one block array. The training inputs, and so the
        fitted artifact on the same device, are **bit-identical** to
        ``fit(concatenate(chunks, axis=1))``; only the peak host memory
        differs (one chunk plus the block array instead of the full field
        plus its normalized copy).

        Transient loader faults (``OSError``/``IOError`` raised during
        chunk iteration) restart the *failing pass* from its beginning:
        each pass is a pure function of the re-iterable loader, so a
        restart is equivalent to a clean first run. Up to
        ``loader_retries`` restarts per pass, with exponential backoff
        starting at ``retry_backoff`` seconds. Validation errors (wrong
        shapes, misaligned chunks) propagate immediately. ``_sleep``
        overrides the backoff sleep (tests).

        The original field is not retained, so ``compress`` reports
        per-species NRMSE from the normalized block vectors (equal to the
        data-space NRMSE up to float rounding: per-species min/max
        normalization makes the range exactly 1).
        """
        geom = self.cfg.geometry
        retry = dict(
            max_retries=loader_retries, backoff=retry_backoff,
            retry_on=(OSError, IOError),
            **({} if _sleep is None else {"sleep": _sleep}),
        )
        t0 = time.perf_counter()

        def pass_ranges():
            # accumulators local to the pass: a mid-iteration fault
            # restarts with a clean slate, never double-counts a chunk
            mn = mx = None
            t_total = 0
            nbytes = 0
            spatial = None
            for chunk in loader.chunks():
                chunk = np.asarray(chunk)
                if chunk.ndim != 4 or chunk.shape[0] != self.n_species:
                    raise ValueError(
                        f"chunk shape {chunk.shape} does not match "
                        f"(S={self.n_species}, Tc, H, W)"
                    )
                if chunk.shape[1] == 0 or chunk.shape[1] % geom.bt:
                    raise ValueError(
                        f"chunk spans {chunk.shape[1]} frames, not a positive "
                        f"multiple of block depth bt={geom.bt}"
                    )
                if spatial is None:
                    spatial = chunk.shape[2:]
                elif chunk.shape[2:] != spatial:
                    raise ValueError(
                        f"chunk grid {chunk.shape[2:]} != first chunk {spatial}"
                    )
                cmn = chunk.min(axis=(1, 2, 3))
                cmx = chunk.max(axis=(1, 2, 3))
                mn = cmn if mn is None else np.minimum(mn, cmn)
                mx = cmx if mx is None else np.maximum(mx, cmx)
                t_total += chunk.shape[1]
                nbytes += chunk.nbytes
            if mn is None:
                raise ValueError("loader yielded no chunks")
            return mn, mx, t_total, nbytes, spatial

        mn, mx, t_total, nbytes, spatial = retry_with_backoff(
            pass_ranges, **retry
        )
        rngs = np.maximum(mx - mn, 1e-30)
        shape = (self.n_species, t_total, *spatial)
        blocking.check_divisible(shape, geom)
        h, w = spatial
        nb = (t_total // geom.bt) * (h // geom.ph) * (w // geom.pw)

        def normed_parts():
            for chunk in loader.chunks():
                chunk = np.asarray(chunk)
                normed = (
                    (chunk - mn[:, None, None, None])
                    / rngs[:, None, None, None]
                ).astype(np.float32)
                yield blocking.to_blocks(normed, geom)

        tail = (self.n_species, geom.bt, geom.ph, geom.pw)
        if self.mesh is not None:
            from repro_torch.parallel.mesh_fit import ShardedBlockStore

            def pass_blocks():
                # mesh ingest: each chunk's blocks land straight in the
                # devices' row shards; the host holds one chunk at a time.
                # A restart refills a fresh store.
                store = ShardedBlockStore(nb, tail, self.mesh)
                for part in normed_parts():
                    store.append(part)
                return store.finish()
        else:
            def pass_blocks():
                # preallocate and fill per chunk: peak memory stays one
                # block array plus one chunk, never the transient 2x a
                # concatenation would cost. Allocated inside the pass so a
                # restart refills from row 0 of a fresh array.
                blocks = _host_alloc((nb, *tail), np.float32)
                row = 0
                for part in normed_parts():
                    blocks[row : row + part.shape[0]] = part
                    row += part.shape[0]
                return blocks

        blocks = retry_with_backoff(pass_blocks, **retry)
        t_ingest = time.perf_counter() - t0
        stats = self._fit_blocks(
            blocks, mn.astype(np.float32), rngs.astype(np.float32),
            shape=shape, data_nbytes=nbytes, data=None, verbose=verbose,
        )
        self.timings["ingest"] = t_ingest
        self.timings["fit_total"] = time.perf_counter() - t0
        return stats

    def _fit_blocks(self, blocks, mn: np.ndarray,
                    rngs: np.ndarray, *, shape, data_nbytes: int,
                    data: Optional[np.ndarray], verbose: bool) -> dict:
        """Fit body over normalized blocks (NB, S, bt, ph, pw): a host
        array, or on a mesh a list of the devices' row shards, over which
        the AE and correction fits run data-parallel."""
        cfg = self.cfg
        mesh = self.mesh
        fit_kw = {} if mesh is None else {"mesh": mesh}
        t0 = time.perf_counter()
        blocks_dev = (torch.from_numpy(blocks).to(self.device) if mesh is None
                      else blocks)
        state, losses = self.family.fit(
            self.model,
            blocks_dev,
            steps=cfg.ae_steps,
            batch_size=cfg.batch_size,
            lr=cfg.lr,
            seed=cfg.seed,
            log_every=200 if verbose else 0,
            device=self.device,
            **fit_kw,
        )
        # parameters leave the trainer in the reference's tree layout (what
        # the wire carries). Honest sub-fp32 storage: round them through the
        # container's storage dtype *before* any of them are used, so the
        # latents, correction fit, and guarantee all see exactly the values
        # the serialized decoder will replay (fp32 is the identity)
        params = quantize_params(convert.to_reference(state),
                                 cfg.param_dtype_bytes)
        t1 = time.perf_counter()
        latents = self._encode(params, blocks_dev)
        t2 = time.perf_counter()

        corr_params = None
        if self.corr_net is not None:
            # decode through the shared fused runtime; pointwise vecs are a
            # transpose away and stay on the device for the correction fit
            ae_vecs = self._decode_vecs(params, latents, None, host=False)
            vec_rec = (ae_vecs.permute(1, 2, 0)
                       .reshape(-1, self.n_species).contiguous())
            del ae_vecs
            if mesh is None:
                vec_orig = correction.blocks_to_pointwise(blocks_dev)
            else:
                # pointwise vectors sharded by the same block rows
                vec_rec = parallel.shard_rows(vec_rec, mesh)
                vec_orig = [correction.blocks_to_pointwise(b) for b in blocks_dev]
            corr_state, _ = correction.fit(
                self.corr_net, vec_rec, vec_orig,
                steps=cfg.corr_steps, seed=cfg.seed + 1, device=self.device,
                **fit_kw,
            )
            del vec_rec, vec_orig
            corr_params = quantize_params(convert.to_reference(corr_state),
                                          cfg.param_dtype_bytes)
        del blocks_dev
        t3 = time.perf_counter()
        self.timings = {"fit_ae": t1 - t0, "encode_latents": t2 - t1,
                        "fit_correction": t3 - t2}

        self._ae_params = params
        self._corr_params = corr_params
        self._latents = latents
        if mesh is None:
            self._vecs_orig = blocking.blocks_as_vectors(blocks)
            self._block_shards = None
        else:
            self._vecs_orig, self._block_shards = None, blocks
        self._data = data
        self._shape = tuple(shape)
        self._data_nbytes = int(data_nbytes)
        self._norm = (mn, rngs)
        self._prepared.clear()
        self._last_prepared = None
        self._packed_params = None
        return {"final_ae_loss": losses[-1] if len(losses) else float("nan")}

    def _encode(self, params, blocks) -> np.ndarray:
        """Blocks -> latents (NB, latent) on the host, in global batches of
        ``_ENCODE_BATCH`` blocks. ``blocks`` is one device tensor or a list
        of equal row shards; a batch that crosses a shard boundary is
        gathered on the device of its first row, so every batch has the
        shape it has on one device (the latents' bits follow the launch
        geometry) and the latents are bitwise the one-device encode's."""
        shards = blocks if isinstance(blocks, list) else [blocks]
        per = shards[0].shape[0]
        nb = per * len(shards)
        states, outs = {}, []
        with torch.no_grad(), strict_fp32():
            for i in range(0, nb, _ENCODE_BATCH):
                dev = shards[i // per].device
                if str(dev) not in states:
                    states[str(dev)] = convert.from_reference(params, device=dev)
                x = parallel.gather_rows(shards, i, min(i + _ENCODE_BATCH, nb), dev)
                outs.append(self.model.encode(x, states[str(dev)]))
        return torch.cat([o.to(outs[0].device) for o in outs]).cpu().numpy()

    def _orig_vectors(self) -> np.ndarray:
        """The original block vectors (S, NB, D) on the host. A mesh fit
        keeps its blocks as the devices' row shards until the first
        compress copies them here (and frees the shards)."""
        if self._vecs_orig is None:
            blocks = torch.cat([b.cpu() for b in self._block_shards]).numpy()
            self._vecs_orig = blocking.blocks_as_vectors(blocks)
            self._block_shards = None
        return self._vecs_orig

    # ------------------------------------------------------------------
    def _decode_vecs(self, ae_params, latents: np.ndarray,
                     corr_params=None, host: bool = True):
        """Latents -> corrected (S, NB, D) vectors via the shared fused
        decode runtime (the same function on the same shapes that
        ``codec.decompress`` replays, so encode-side guarantees see
        bit-identical x_rec). ``host=False`` skips the host fetch."""
        from repro_torch import codec

        rt = codec._runtime(self.cfg, self.n_species,
                            corr_params is not None, self.device)
        lat32 = np.ascontiguousarray(np.asarray(latents, dtype=np.float32))
        out = codec._fused_vecs(rt, ae_params, corr_params, lat32)
        return out.cpu().numpy() if host else out

    def _prepare_guarantee(self, latent_bin_rel: float, skip_correction: bool):
        """Decode + tau-independent guarantee prep, cached per sweep key.

        Cold keys seed the engine's shared-residual incremental prepare
        with the most recent prepared state: species whose reconstruction
        is unchanged (e.g. toggling ``skip_correction`` on a pipeline with
        no correction net) reuse their PCA/projection/energy-ordering."""
        lat_bin = float(latent_bin_rel * max(self._latents.std(), 1e-12))
        key = (lat_bin, bool(skip_correction))
        hit = self._prepared.get(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        lat_q = quantize(self._latents, lat_bin)
        corr_params = None if skip_correction else self._corr_params
        vecs_rec = self._decode_vecs(
            self._ae_params, dequantize(lat_q, lat_bin), corr_params
        )
        t1 = time.perf_counter()
        prepared = self._gengine.prepare(
            self._orig_vectors(), vecs_rec, reuse=self._last_prepared
        )
        self._last_prepared = prepared
        self.timings.update(
            decode_vecs=t1 - t0, prepare=time.perf_counter() - t1,
            prepare_stages=dict(self._gengine.last_prepare_s),
        )
        # latent wire streams are NOT packed here — the artifact packs
        # lazily per shard layout into this shared memo, so a sweep pays
        # each pack once and a pure-report sweep pays none
        entry = (prepared, lat_q, lat_bin, corr_params, {})
        # bounded FIFO: each entry pins several (S, NB, D) fp64 tensors, and
        # a latent_bin_rel sweep would otherwise accumulate one per value
        while len(self._prepared) >= self._PREPARED_CACHE_MAX:
            self._prepared.pop(next(iter(self._prepared)))
        self._prepared[key] = entry
        return entry

    def _packed_param_streams(self) -> tuple:
        """Pre-packed decoder/correction wire streams, cached per fit —
        a target_nrmse sweep serializes many artifacts off one fitted
        model, and the parameter streams are identical in all of them."""
        if self._packed_params is None:
            from repro_torch import codec

            self._packed_params = codec.pack_artifact_params(
                self._ae_params, self._corr_params, self.cfg.param_dtype_bytes
            )
        return self._packed_params

    def compress(
        self,
        target_nrmse: float = 1e-3,
        latent_bin_rel: float = 0.05,
        coeff_bin: float = 0.0,
        skip_correction: bool = False,
    ) -> CompressionReport:
        """Cheap per-error-bound pass reusing the fitted networks.

        ``skip_correction=True`` reports the GBA variant off the same fitted
        AE (the correction net is trained after the AE, so GBA and GBATC
        legitimately share the encoder — paper §II-C). Sweeping
        ``target_nrmse`` reuses the cached tau-independent guarantee state,
        so each additional error bound costs only the engine's select pass."""
        if self._latents is None:
            raise RuntimeError("call fit() first")
        cfg = self.cfg
        geom = cfg.geometry
        shape = self._shape
        mn, rngs = self._norm
        t_start = time.perf_counter()

        prepared, lat_q, lat_bin, corr_params, latent_memo = \
            self._prepare_guarantee(latent_bin_rel, skip_correction)

        d = geom.block_size
        tau = target_nrmse * np.sqrt(d)  # normalized range == 1
        t0 = time.perf_counter()
        corrected, arts = self._gengine.select(prepared, tau, coeff_bin)
        t1 = time.perf_counter()

        artifact = CompressedArtifact(
            latent_q=lat_q,
            latent_bin=lat_bin,
            ae_params=self._ae_params,
            corr_params=corr_params,
            species_guarantees=arts,
            norm_min=mn,
            norm_range=rngs,
            shape=shape,
            cfg=cfg,
            _param_streams=self._packed_param_streams(),
            _latent_memo=latent_memo,
            # a mesh fit packs its latents as the shards' row blocks
            _latent_parts=(None if self.mesh is None
                           else np.split(lat_q, self.mesh.size)),
        )

        rec_blocks = blocking.vectors_as_blocks(corrected, geom)
        rec_normed = blocking.from_blocks(rec_blocks, shape, geom)
        recon = rec_normed * rngs[:, None, None, None] + mn[:, None, None, None]

        t2 = time.perf_counter()
        bb = artifact.byte_breakdown()  # serializes the container
        t3 = time.perf_counter()
        if self._data is not None:
            per_species = np.array(
                [metrics.nrmse(self._data[s], recon[s])
                 for s in range(self.n_species)]
            )
        else:
            # streamed fit: the original field was never materialized.
            # NRMSE is range-normalized and per-species min/max
            # normalization makes the range exactly 1, so the normalized
            # block-vector RMS *is* the NRMSE (up to float rounding; the
            # guarantee itself is enforced in normalized units either way)
            err = corrected - self._orig_vectors()
            per_species = np.sqrt(np.mean(np.square(err), axis=(1, 2)))
        t4 = time.perf_counter()
        self.timings.update(select=t1 - t0, encode=t3 - t2,
                            report=(t2 - t1) + (t4 - t3),
                            compress_total=t4 - t_start)
        return CompressionReport(
            recon=recon.astype(np.float32),
            compression_ratio=self._data_nbytes / bb["total"],
            mean_nrmse=float(per_species.mean()),
            per_species_nrmse=per_species,
            bytes_breakdown=bb,
            artifact=artifact,
        )

    def fit_compress(self, data: np.ndarray, verbose: bool = False,
                     target_nrmse: float = 1e-3, **kw) -> CompressionReport:
        self.fit(data, verbose=verbose)
        return self.compress(target_nrmse=target_nrmse, **kw)

    # ------------------------------------------------------------------
    def decompress(self, artifact: CompressedArtifact) -> np.ndarray:
        """Replay stored streams only (no access to the original data).

        Compatibility wrapper over ``repro_torch.codec.reconstruct``: the decode
        structure — geometry, AE shape, whether correction runs — comes
        from the *artifact*, never from this pipeline's config. An artifact
        whose structure disagrees with this pipeline raises rather than
        silently decoding with the wrong networks (the seed would e.g. let
        a GBA-configured pipeline skip a GBATC artifact's correction); an
        artifact that only differs in correction presence decodes fine, so
        GBA reports off a shared encoder keep working.
        """
        # family-aware structural identity; correction presence and param
        # storage width may legitimately differ (GBA reports off a shared
        # encoder, fp16-stored params), so neutralize those fields
        a = dataclasses.replace(
            _structural(artifact.cfg), use_correction=False,
            param_dtype_bytes=4,
        )
        p = dataclasses.replace(
            self.scfg, use_correction=False, param_dtype_bytes=4
        )
        if a != p or len(artifact.norm_min) != self.n_species:
            raise ValueError(
                f"artifact structure (family={a.family}, geometry={a.geometry}, "
                f"latent={a.latent}, arch={a.arch}, S={len(artifact.norm_min)}) "
                f"does not match this pipeline (family={p.family}, "
                f"geometry={p.geometry}, latent={p.latent}, arch={p.arch}, "
                f"S={self.n_species}); use repro_torch.codec.decompress / "
                f"codec.reconstruct, which derive everything from the artifact"
            )
        from repro_torch import codec

        return codec.reconstruct(artifact, device=self.device)


class GBATCCodec:
    """Bytes-in/bytes-out GBATC (or GBA, via ``cfg.use_correction=False``).

    Usage::

        codec = GBATCCodec(PipelineConfig(...))
        codec.fit(data)                       # train AE (+ correction) once
        blob = codec.compress(target_nrmse=1e-3)   # -> container bytes
        field = repro_torch.codec.decompress(blob)  # anywhere, no codec

    ``compress(data=...)`` fits on the given data first (refitting if the
    codec was already fitted), so one-shot compression is a single call;
    ``fit_stream(loader)`` consumes time-chunked input without ever
    materializing the full field (see :meth:`GBATCPipeline.fit_stream`).
    Error-bound sweeps against one fitted model reuse the pipeline's cached
    tau-independent guarantee state.

    ``device=None`` means the GPU and raises without CUDA; ``mesh`` runs
    the fits and compress mesh-sharded, as :class:`GBATCPipeline`. The
    class lives with the orchestration layer (it owns a fit), and
    ``repro_torch.codec.GBATCCodec`` re-exports it; the decode side of the
    codec package never imports this module.
    """

    def __init__(self, cfg: Optional[PipelineConfig] = None,
                 n_species: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        self.cfg = cfg if cfg is not None else PipelineConfig()
        self.mesh = mesh
        self.device = _mesh_device(device, mesh)
        self._pipe: Optional[GBATCPipeline] = (
            GBATCPipeline(self.cfg, n_species, device=self.device, mesh=mesh)
            if n_species is not None else None
        )

    @property
    def pipeline(self) -> Optional[GBATCPipeline]:
        """The underlying fit/orchestration layer (None before first fit)."""
        return self._pipe

    @property
    def fitted(self) -> bool:
        return self._pipe is not None and self._pipe._latents is not None

    def fit(self, data: np.ndarray, verbose: bool = False) -> "GBATCCodec":
        data = np.asarray(data)
        if data.ndim != 4:
            raise ValueError(
                f"expected (S, T, H, W) species data, got "
                f"{data.ndim}-d {type(data).__name__} of shape {data.shape}"
                " (note: compress(target_nrmse=...) is keyword-only via the"
                " data-first signature)"
            )
        if self._pipe is None or self._pipe.n_species != data.shape[0]:
            self._pipe = GBATCPipeline(self.cfg, n_species=data.shape[0],
                                       device=self.device, mesh=self.mesh)
        self._pipe.fit(data, verbose=verbose)
        return self

    def fit_stream(self, loader, verbose: bool = False, *,
                   loader_retries: int = 2, retry_backoff: float = 0.1,
                   _sleep=None) -> "GBATCCodec":
        """Fit from time-chunked input without materializing the field.

        ``loader`` must expose ``shape`` (the full (S, T, H, W)) and a
        re-iterable ``chunks()`` yielding consecutive (S, Tc, H, W) time
        chunks (each Tc divisible by the block geometry's ``bt``), e.g.
        :class:`repro_torch.data.s3d.S3DChunkLoader`. On the same device
        the fit is bit-identical to ``fit(concatenate(chunks, axis=1))``.

        Transient loader faults (I/O errors mid-iteration) restart the
        failing pass from its beginning with exponential backoff (up to
        ``loader_retries`` restarts per pass, ``retry_backoff`` seconds
        doubling per attempt), and the result stays bit-identical to a
        clean run. Shape and validation errors are never retried.
        """
        s = int(loader.shape[0])
        if self._pipe is None or self._pipe.n_species != s:
            self._pipe = GBATCPipeline(self.cfg, n_species=s,
                                       device=self.device, mesh=self.mesh)
        self._pipe.fit_stream(
            loader, verbose=verbose, loader_retries=loader_retries,
            retry_backoff=retry_backoff, _sleep=_sleep,
        )
        return self

    def compress(self, data: Optional[np.ndarray] = None,
                 target_nrmse: float = 1e-3, **kw) -> bytes:
        """Compress to container bytes; pass ``data`` to (re)fit first."""
        blob, _ = self.compress_report(data, target_nrmse=target_nrmse, **kw)
        return blob

    def compress_report(
        self, data: Optional[np.ndarray] = None,
        target_nrmse: float = 1e-3, **kw,
    ) -> tuple[bytes, CompressionReport]:
        """Like :meth:`compress`, also returning the quality report."""
        if data is not None:
            self.fit(data)
        if not self.fitted:
            raise RuntimeError("codec not fitted: pass data or call fit() first")
        rep = self._pipe.compress(target_nrmse=target_nrmse, **kw)
        return rep.artifact.to_bytes(), rep

    def write(self, path, data: Optional[np.ndarray] = None,
              target_nrmse: float = 1e-3, **kw) -> bytes:
        """Compress and atomically publish the container at ``path``
        (tmp + fsync + rename — a crash can never leave a half-blob).
        Pass ``data`` to (re)fit first. Returns the written bytes."""
        from repro_torch.codec.encode import write as write_file

        blob = self.compress(data, target_nrmse=target_nrmse, **kw)
        write_file(path, blob)
        return blob

    @staticmethod
    def read(path, *, verify: bool = True) -> bytes:
        """Read (and by default digest-verify) a container file; see
        :func:`repro_torch.codec.read`."""
        from repro_torch.codec.encode import read as read_file

        return read_file(path, verify=verify)

    def decompress(self, blob: bytes, *, species=None, time_range=None,
                   on_error: str = "raise", device: DeviceLike = None):
        """Decode a container blob (stateless; see
        :func:`repro_torch.codec.decompress`) on ``device``, by default
        this codec's.

        ``species``/``time_range`` select a slice to decode
        randomly-accessed, bitwise equal to slicing the full decode;
        ``on_error="salvage"`` quarantines corruption and returns
        ``(field, DecodeReport)``."""
        from repro_torch.codec.decode import decompress

        return decompress(
            blob, species=species, time_range=time_range, on_error=on_error,
            device=self.device if device is None else device,
        )
