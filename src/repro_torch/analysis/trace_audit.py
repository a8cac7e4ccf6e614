"""Trace-time program auditor: every aten op of the registered hot programs.

The counterpart of the JAX package's ``analysis/jaxpr_audit.py``. Eager
PyTorch has no jaxpr to walk, so each registered program is *run* once —
on the card unless the caller asks for the CPU — under a
``TorchDispatchMode`` that sees every aten op it dispatches (autograd's
backward ops included), and on the card also under
``torch.cuda.set_sync_debug_mode``. The reference's checks map as follows:

* **fp64 promotion**: an op with a float64 output is a finding unless
  the program is allowlisted (the five GBATC programs, whose guarantee
  math is fp64 by design);
* **host syncs** (the reference's host callbacks): ``_local_scalar_dense``
  (``.item()``, ``float(t)``), ``nonzero``, ``masked_select``, ``unique``
  and boolean-mask indexing, and on the card any synchronising CUDA call
  (``set_sync_debug_mode("error")``). Only the trainer's ``log_every``
  program may sync: once a logged step, plus the one fetch of the loss
  history at the end of ``fit``;
* **mid-program transfers**: a ``_to_copy`` / ``copy_`` whose source and
  destination devices differ;
* **captured constants** (the reference's folded constants): the bytes of
  tensors a program reads that are neither its arguments nor made inside
  it — data that should have been an argument; over 1 MiB is a finding;
* **in-place carries** (the reference's donation check): after a step of
  a trainer program the parameters and AdamW moments it returns are the
  tensors it was given, storage for storage;
* **collectives where expected**: a data-parallel step exchanges its
  gradients (``parallel/mesh_fit.py``'s ``psum``, or the int8 exchange on
  ``block_quant``) iff its mesh has more than one replica; the sharded
  guarantee engine's per-chunk programs exchange nothing;
* **own kernels** (the card only): each program launches its own kernel
  (the wrappers' launch counters);
* **retrace counting**: eager PyTorch traces nothing, so the reference's
  jit-cache counts are reported as ``None``; what has a counterpart is
  held instead — repeated fused decodes of one blob signature use one
  cached decode runtime (``codec/runtime.py``), and the kernel libraries
  load once a process (``kernels/_build.py``).

Setup guard (the x64 guard's counterpart): the default dtype must be
float32, and the TF32 flags must be the same after the audit as before.

The registry (:func:`program_specs`) holds the reference's 13 program
names, each mapped to its port counterpart, over a :class:`Workload`: a
tiny one made from seeds (:func:`tiny_workload`, the CLI's) or the
fitted state of a real codec run (:func:`workload_from`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

RULE = "trace-audit"
HERE = "analysis/trace_audit.py"

#: aten ops that read a device value on the host (``.item()``, ``float(t)``
#: and ``bool(t)`` reach ``_local_scalar_dense``; ``torch.unique`` one of
#: the ``_unique`` forms)
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "equal",
})
#: ops whose boolean index is a hidden ``nonzero``
_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
_COPY_OPS = frozenset({"_to_copy", "copy_"})
LARGE_CONST_BYTES = 1 << 20
#: the kernels' launch-counter modules
_WRAPPERS = ("gbatc_project", "flash_attention", "block_quant", "rglru_scan",
             "rwkv6_scan")
_NO_JIT = ("eager PyTorch compiles no programs: the reference's jit-cache "
           "entry and retrace counts have no counterpart here")


@dataclasses.dataclass
class ProgramStats:
    """What one run of a program did."""

    n_ops: int = 0
    syncs: dict = dataclasses.field(default_factory=dict)
    device_syncs: Optional[int] = None  # the card only
    transfers: int = 0
    transfer_bytes: int = 0
    f64_ops: int = 0
    const_bytes: int = 0
    collectives: int = 0
    in_place: Optional[bool] = None
    launches: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def n_syncs(self) -> int:
        return sum(self.syncs.values())


@dataclasses.dataclass
class AuditReport:
    findings: list = dataclasses.field(default_factory=list)
    programs: dict = dataclasses.field(default_factory=dict)
    caches: dict = dataclasses.field(default_factory=dict)
    device: str = ""
    wall_clock_s: float = 0.0


@dataclasses.dataclass
class ProgramSpec:
    """One registered hot program.

    ``build()`` returns ``(fn, args)``, run as ``fn(*args)`` with ``args``
    already on the device. ``allow_f64`` exempts the program from the fp64
    finding; ``allowed_syncs`` / ``allowed_transfers`` are the host reads
    and cross-device copies it may make (the ``log_every`` program's
    logged losses and its history fetch); ``check_carry`` holds the
    trainer contract that the outputs' first two items (parameters, state)
    are the arguments' first two, storage for storage;
    ``expect_collectives`` True requires a gradient exchange, False
    forbids one, None does not check; ``kernels`` are the launch counters
    that must move on the card.
    """

    name: str
    build: Callable[[], tuple]
    allow_f64: bool = False
    allowed_syncs: int = 0
    allowed_transfers: int = 0
    check_carry: bool = False
    expect_collectives: Optional[bool] = None
    kernels: tuple = ()


# --------------------------------------------------------------------------
# the recorder


def _tensors(obj):
    """Every tensor in a nest of tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _storage_key(t: torch.Tensor):
    if t.device.type == "meta" or t.numel() == 0:
        return None
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    return (str(t.device), st.data_ptr()), st.nbytes()


class _Recorder(TorchDispatchMode):
    """Counts what :class:`ProgramStats` counts for every aten op."""

    def __init__(self, stats: ProgramStats, args):
        super().__init__()
        self.stats = stats
        self.known = {k for k, _ in filter(None, map(_storage_key, _tensors(args)))}
        self.captured: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        inputs = list(_tensors((args, kwargs)))
        for t in inputs:
            key = _storage_key(t)
            if key is not None and key[0] not in self.known:
                self.captured[key[0]] = key[1]
        out = func(*args, **kwargs)
        st = self.stats
        st.n_ops += 1
        if name in SYNC_OPS or (name in _INDEX_OPS and any(
                t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1:2]))):
            st.syncs[name] = st.syncs.get(name, 0) + 1
        outputs = list(_tensors(out))
        if name in _COPY_OPS and inputs and outputs:
            src, dst = (inputs[0], outputs[0]) if name == "_to_copy" else (
                inputs[1] if len(inputs) > 1 else inputs[0], inputs[0])
            if src.device != dst.device:
                st.transfers += 1
                st.transfer_bytes += src.numel() * src.element_size()
        if any(t.dtype == torch.float64 for t in outputs):
            st.f64_ops += 1
        for t in outputs:
            key = _storage_key(t)
            if key is not None:
                self.known.add(key[0])
        return out


def _launch_counts() -> dict:
    import importlib

    counts = {}
    for mod in _WRAPPERS:
        counts.update(importlib.import_module(
            f"repro_torch.kernels.{mod}").launch_counts())
    return counts


def _exchanges() -> int:
    from repro_torch.parallel import mesh_fit

    return sum(mesh_fit.EXCHANGES.values())


def _carry_ptrs(params, state) -> list:
    return [t.data_ptr() for t in _tensors((params, state))]


def _run(spec: ProgramSpec, fn, args, device: torch.device, stats: ProgramStats):
    """Run ``fn(*args)`` under the recorder (and the card's sync check);
    returns the output, or raises the sync check's error."""
    rec = _Recorder(stats, args)
    on_card = device.type == "cuda"
    allowed = spec.allowed_syncs + spec.allowed_transfers
    if on_card:
        torch.cuda.synchronize(device)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn" if allowed else "error")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with rec:
                out = fn(*args)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev)
    if on_card:
        torch.cuda.synchronize(device)
        stats.device_syncs = sum("synchronizing" in str(w.message) for w in caught)
    stats.const_bytes = sum(rec.captured.values())
    return out


def _audit_program(spec: ProgramSpec, report: AuditReport,
                   device: torch.device) -> None:
    fn, args = spec.build()
    stats = ProgramStats()
    report.programs[spec.name] = stats
    carry = _carry_ptrs(args[0], args[1]) if spec.check_carry else None
    launches0, exchanges0 = _launch_counts(), _exchanges()
    t0 = time.perf_counter()

    def finding(detail):
        report.findings.append(Finding(RULE, HERE, 0,
                                       f"program {spec.name!r} {detail}"))

    try:
        out = _run(spec, fn, args, device, stats)
    except RuntimeError as e:
        if "synchronizing" not in str(e):
            raise
        stats.seconds = time.perf_counter() - t0
        finding(f"synchronises with the host on the card: {e}")
        return
    stats.seconds = time.perf_counter() - t0
    after = _launch_counts()
    stats.launches = {k: n - launches0[k] for k, n in after.items()
                      if n != launches0[k]}
    stats.collectives = _exchanges() - exchanges0

    if stats.n_syncs > spec.allowed_syncs:
        finding(f"contains {stats.n_syncs} host sync(s) {stats.syncs} "
                f"(allowed {spec.allowed_syncs})")
    if stats.device_syncs is not None and \
            stats.device_syncs > spec.allowed_syncs + spec.allowed_transfers:
        finding(f"synchronises with the host {stats.device_syncs}x on the card "
                f"(allowed {spec.allowed_syncs + spec.allowed_transfers})")
    if stats.transfers > spec.allowed_transfers:
        finding(f"contains {stats.transfers} mid-program device transfer(s) "
                f"(allowed {spec.allowed_transfers})")
    if stats.f64_ops and not spec.allow_f64:
        finding(f"promotes to float64 in {stats.f64_ops} op(s) outside the "
                f"guarantee-math allowlist")
    if stats.const_bytes > LARGE_CONST_BYTES:
        finding(f"reads {stats.const_bytes} bytes of captured tensors that are "
                f"not its arguments (> {LARGE_CONST_BYTES})")
    if spec.expect_collectives is True and stats.collectives == 0:
        finding("exchanges no gradients but the mesh has several replicas — "
                "shards would train on unexchanged gradients")
    if spec.expect_collectives is False and stats.collectives:
        finding(f"makes {stats.collectives} gradient exchange(s) but must be "
                f"device-independent")
    if carry is not None:
        stats.in_place = carry == _carry_ptrs(out[0], out[1])
        if not stats.in_place:
            finding("does not update its carries in place (parameters and "
                    "AdamW moments come back in new storage)")
    if device.type == "cuda":
        for kernel in spec.kernels:
            if not stats.launches.get(kernel):
                finding(f"launched no {kernel} kernel")


# --------------------------------------------------------------------------
# what the programs run on


@dataclasses.dataclass
class Workload:
    """Inputs of the registry's programs, on ``device``.

    ``conv_cfg`` / ``attn_cfg`` are the two families' pipeline configs
    over ``n_species`` species; ``ae_params`` / ``corr_params`` /
    ``attn_params`` flat parameter dicts; ``latents`` / ``attn_latents``
    (NB, latent) fp32; ``blocks`` the training rows (NB, S, bt, ph, pw);
    ``x`` / ``x_rec`` the guarantee's (S, NB, D) originals and fp32
    reconstructions (host arrays, as the engine takes them) and ``tau``
    its bound; ``mesh_size`` the data-parallel width and ``n_shards`` the
    sharded engine's chunk count."""

    device: torch.device
    n_species: int
    conv_cfg: Any
    attn_cfg: Any
    ae_params: dict
    corr_params: dict
    attn_params: dict
    latents: torch.Tensor
    attn_latents: torch.Tensor
    blocks: torch.Tensor
    batch_size: int
    x: np.ndarray
    x_rec: np.ndarray
    tau: float
    mesh_size: int = 4
    n_shards: int = 2


def tiny_workload(device) -> Workload:
    """The CLI's workload: two species, (2, 4, 4) blocks, seeded data and
    the decode runtimes' own initial weights."""
    from repro_torch.codec import runtime as rt_mod
    from repro_torch.core.blocking import BlockGeometry
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    s, geom, latent = 2, BlockGeometry(bt=2, ph=4, pw=4), 8
    conv_cfg = PipelineConfig(geometry=geom, latent=latent, conv_channels=(4,),
                              use_correction=True)
    attn_cfg = PipelineConfig(geometry=geom, latent=latent, family="attention",
                              arch=(16, 2, 1, 32), use_correction=False)
    conv = rt_mod._runtime(conv_cfg, s, True, dev)
    attn = rt_mod._runtime(attn_cfg, s, False, dev)
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((s, 64, geom.block_size)).astype(np.float32)
    x_rec = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return Workload(
        device=dev, n_species=s, conv_cfg=conv_cfg, attn_cfg=attn_cfg,
        ae_params=conv.model.params(), corr_params=conv.corr_net.params(),
        attn_params=attn.model.params(),
        latents=torch.randn((16, latent), generator=g).to(dev),
        attn_latents=torch.randn((16, latent), generator=g).to(dev),
        blocks=torch.randn((32, s, 2, 4, 4), generator=g).to(dev),
        batch_size=8, x=x, x_rec=x_rec, tau=0.3,
    )


def workload_from(pipeline, attention_artifact) -> Workload:
    """The workload of a real run: a fitted conv-family ``GBATCPipeline``
    (its parameters, latents and original block vectors; the guarantee's
    reconstruction is its fused decode) and an attention-family
    ``CompressedArtifact`` (its parameters and dequantized latents); the
    guarantee at 1e-3 of the normalized field, the main path's bound; a
    mesh of 4 and 4 chunks, as the card's ``mesh_path``."""
    from repro_torch import convert
    from repro_torch.core import blocking
    from repro_torch.core.quantization import dequantize

    dev = pipeline.device
    cfg = pipeline.cfg
    x = pipeline._orig_vectors()
    x_rec = pipeline._decode_vecs(pipeline._ae_params, pipeline._latents,
                                  pipeline._corr_params)
    art = attention_artifact
    lat_a = dequantize(art.latent_q, art.latent_bin).astype(np.float32)
    return Workload(
        device=dev, n_species=pipeline.n_species, conv_cfg=cfg,
        attn_cfg=art.cfg,
        ae_params=convert.from_reference(pipeline._ae_params, device=dev),
        corr_params=convert.from_reference(pipeline._corr_params, device=dev),
        attn_params=convert.from_reference(art.ae_params, device=dev),
        latents=torch.from_numpy(np.ascontiguousarray(
            pipeline._latents, dtype=np.float32)).to(dev),
        attn_latents=torch.from_numpy(lat_a).to(dev),
        blocks=torch.from_numpy(blocking.vectors_as_blocks(
            x, cfg.geometry)).to(dev),
        batch_size=cfg.batch_size, x=x, x_rec=x_rec,
        tau=1e-3 * float(np.sqrt(cfg.geometry.block_size)), n_shards=4,
    )


# --------------------------------------------------------------------------
# the registry


def _under_fp32(fn):
    """``fn`` under the trainers' numerics scope (``fit`` runs its steps in
    it)."""
    from repro_torch.device import strict_fp32

    @functools.wraps(fn)
    def run(*args):
        with strict_fp32():
            return fn(*args)

    return run


def _fresh(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def _first_chunk(kernel: str, args: tuple, n_shards: int, device) -> tuple:
    """The sharded engine's first chunk of a batched program's operands
    (its own plan), on ``device``."""
    from repro_torch.parallel import mesh_fit

    plan = mesh_fit._KERNEL_PLANS[kernel]
    lead = next(a for a, ax in zip(args, plan) if ax == "SR")
    s0, s1, r0, r1 = mesh_fit._chunk_plan(int(lead.shape[0]), int(lead.shape[1]),
                                          n_shards)[0]
    return tuple(
        a if ax is None else
        (a[s0:s1] if ax == "S" else a[s0:s1, r0:r1]).contiguous().to(device)
        for a, ax in zip(args, plan))


def program_specs(w: Workload) -> list[ProgramSpec]:
    """The reference's 13 programs (``jaxpr_audit._program_specs``), each
    as its port counterpart over ``w``:

    * ``trainer_stream_step``, ``trainer_scan_hot``:
      ``MiniBatchTrainer.step`` (the port has one trainer mode, an eager
      loop of steps, so both names are its step);
    * ``trainer_scan_log_every``: ``MiniBatchTrainer.fit`` with
      ``log_every``;
    * ``trainer_mesh_dp``, ``trainer_mesh_dp_quantized``:
      ``parallel/mesh_fit.py::dp_step``, plain and int8, over
      ``w.mesh_size`` replicas (one replica: the plain step, as ``fit``);
    * ``fused_decode``, ``fused_decode_corrected``,
      ``fused_decode_attention``: ``codec/runtime.py::_fused_vecs`` on the
      cached decode runtime (attention through flash);
    * ``gbatc_project_batched``, ``gbatc_correct_batched``,
      ``gbatc_select_accumulate``: ``GuaranteeEngine._dispatch`` of
      ``project`` / ``apply`` / ``select`` (the device select backend);
    * ``gbatc_project_shard``, ``gbatc_select_accumulate_shard``: the
      program ``ShardedGuaranteeEngine._dispatch`` runs on its first chunk.
    """
    from repro_torch.codec import runtime as rt_mod
    from repro_torch.core import autoencoder, gae
    from repro_torch.parallel import mesh_fit
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop

    dev, s = w.device, w.n_species
    ocfg = opt.adamw_cfg(1e-3, 8)
    trainer = train_loop.MiniBatchTrainer(
        autoencoder.ae_loss(rt_mod._runtime(w.conv_cfg, s, True, dev).model),
        ocfg, log_fn=lambda t, loss: None)
    bs = w.batch_size
    specs = []

    def step_build():
        params = _fresh(w.ae_params)
        return (_under_fp32(trainer.step),
                (params, opt.init_state(params), (w.blocks[:bs],)))

    for name in ("trainer_stream_step", "trainer_scan_hot"):
        specs.append(ProgramSpec(name=name, build=step_build, check_carry=True))

    logged = 2  # steps 0 and 4 of 8

    def fit_build():
        def fit(params, blocks):
            return trainer.fit(params, (blocks,), steps=8, batch_size=bs, seed=0,
                               log_every=4, device=dev)
        return fit, (_fresh(w.ae_params), w.blocks)

    specs.append(ProgramSpec(name="trainer_scan_log_every", build=fit_build,
                             allowed_syncs=logged, allowed_transfers=1))

    # data parallel over a mesh repeating the device (the port's forced
    # host devices); a 1-replica mesh runs the plain step
    n_p = w.mesh_size
    per = max(bs // n_p, 1)
    for name, quantized in (("trainer_mesh_dp", False),
                            ("trainer_mesh_dp_quantized", True)):
        def dp_build(quantized=quantized):
            if n_p == 1:
                return step_build()
            replicas = [_fresh(w.ae_params) for _ in range(n_p)]
            states = [opt.init_state(r) for r in replicas]
            batches = [(w.blocks[i * per:(i + 1) * per],) for i in range(n_p)]

            def step(replicas, states, batches):
                return mesh_fit.dp_step(trainer, replicas, states, batches,
                                        quantized=quantized)
            return _under_fp32(step), (replicas, states, batches)

        specs.append(ProgramSpec(
            name=name, build=dp_build, check_carry=True,
            expect_collectives=n_p > 1,
            kernels=("block_quant",) if quantized and n_p > 1 else ()))

    # the fused decode (decode runtime's fused function, all chunks)
    for name, cfg, corr, params, lat, kernels in (
            ("fused_decode", w.conv_cfg, None, w.ae_params, w.latents, ()),
            ("fused_decode_corrected", w.conv_cfg, w.corr_params, w.ae_params,
             w.latents, ()),
            ("fused_decode_attention", w.attn_cfg, None, w.attn_params,
             w.attn_latents, ("flash_attention",))):
        def fused_build(cfg=cfg, corr=corr, params=params, lat=lat):
            rt = rt_mod._runtime(cfg, s, corr is not None, dev)
            return functools.partial(rt_mod._fused_vecs, rt), (params, corr, lat)

        specs.append(ProgramSpec(name=name, build=fused_build, kernels=kernels))

    # the guarantee engine's batched programs: inputs prepared once
    prep_cache: dict = {}

    def prepared():
        if not prep_cache:
            eng = gae.GuaranteeEngine(dev, select_backend="device")
            prep = eng.prepare(w.x, w.x_rec)
            residual = eng._stage(w.x.astype(np.float64)
                                  - w.x_rec.astype(np.float64))
            d = prep.shape[2]
            bin_size = gae._effective_bin(0.0, w.tau, d)
            _, arts = eng.select(prep, w.tau)
            dense, basis_pad = eng.dense_corrections(arts, prep.shape)
            prep_cache.update(
                eng=eng,
                project=(residual, eng._stage(prep.basis)),
                select=(prep.coeffs_dev, prep.coeffs_sorted_dev,
                        prep.inv_rank_dev, prep.norms2_dev, prep.x_rec_dev,
                        prep.basis32_dev, w.tau * w.tau, bin_size),
                apply=(prep.x_rec_dev, eng._stage(dense), eng._stage(basis_pad)))
        return prep_cache

    sharded = mesh_fit.ShardedGuaranteeEngine(n_shards=w.n_shards, device=dev,
                                              select_backend="device")
    for name, kernel, counter, shard in (
            ("gbatc_project_batched", "project", "gbatc_project_batched", False),
            ("gbatc_correct_batched", "apply", "gbatc_correct_batched", False),
            ("gbatc_select_accumulate", "select", "gbatc_select_accumulate", False),
            ("gbatc_project_shard", "project", "gbatc_project_batched", True),
            ("gbatc_select_accumulate_shard", "select",
             "gbatc_select_accumulate", True)):
        def gbatc_build(kernel=kernel, shard=shard):
            p = prepared()
            if shard:
                chunk = _first_chunk(kernel, p[kernel], w.n_shards, dev)
                return getattr(sharded, f"_{kernel}"), chunk
            return functools.partial(p["eng"]._dispatch, kernel), p[kernel]

        specs.append(ProgramSpec(
            name=name, build=gbatc_build, allow_f64=True,
            expect_collectives=False if shard else None, kernels=(counter,)))
    return specs


# --------------------------------------------------------------------------
# caches (the retrace counts' counterpart) and the whole audit


def _audit_caches(w: Workload, report: AuditReport) -> None:
    from repro_torch.codec import runtime as rt_mod

    dev, s = w.device, w.n_species
    rt = rt_mod._runtime(w.conv_cfg, s, False, dev)
    n0 = len(rt_mod._RUNTIMES)
    for _ in range(2):
        rt_mod._fused_vecs(rt_mod._runtime(w.conv_cfg, s, False, dev),
                           w.ae_params, None, w.latents)
    reused = rt_mod._runtime(w.conv_cfg, s, False, dev) is rt
    added = len(rt_mod._RUNTIMES) - n0
    libraries = None
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        first = dict(_build.load())
        again = _build.load()
        libraries = {"loaded": sorted(first),
                     "loaded_once": all(again[k] is v for k, v in first.items())
                     and len(first) == len(_build.SOURCES)}
    report.caches = {
        "jit_cache_entries": None, "retraces": None, "note": _NO_JIT,
        "decode_runtime_reused": reused, "decode_runtimes_added": added,
        "kernel_libraries": libraries,
    }
    if not reused or added:
        report.findings.append(Finding(
            RULE, HERE, 0,
            f"repeated fused decodes of one signature built {added} new decode "
            f"runtime(s) (expected the cached one)"))
    if libraries is not None and not libraries["loaded_once"]:
        report.findings.append(Finding(
            RULE, HERE, 0, "the kernel libraries were loaded more than once"))


def _fp32_flags() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def audit(device=None, workload: Optional[Workload] = None) -> AuditReport:
    """Run the registry and the cache checks on ``device`` (``None``: the
    GPU, raising without one) over ``workload`` (default
    :func:`tiny_workload`, on ``device``; a workload runs on its own
    device); returns findings and per-program stats."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device if workload is None else workload.device)
    report = AuditReport(device=str(dev))
    t0 = time.perf_counter()
    if torch.get_default_dtype() != torch.float32:
        report.findings.append(Finding(
            RULE, HERE, 0,
            f"the default dtype is {torch.get_default_dtype()}, not float32 — "
            f"audit aborted"))
        report.wall_clock_s = time.perf_counter() - t0
        return report
    flags = _fp32_flags()
    w = workload if workload is not None else tiny_workload(dev)
    for spec in program_specs(w):
        _audit_program(spec, report, dev)
    _audit_caches(w, report)
    if torch.get_default_dtype() != torch.float32 or _fp32_flags() != flags:
        report.findings.append(Finding(
            RULE, HERE, 0,
            "an audited program changed the default dtype or the TF32 flags "
            "and left them changed"))
    report.wall_clock_s = time.perf_counter() - t0
    return report
