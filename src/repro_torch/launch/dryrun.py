"""Dry run: the bytes each device holds and the FLOPs of one step, for every
(arch x shape x mesh) cell, with no device at all.

The counterpart of the JAX package's ``launch/dryrun.py``. The reference
lowers and compiles each cell's step with GSPMD against 512 placeholder
devices and reads XLA's memory and cost analyses. This package has one
controller over a device list and no partitioner, so its dry run is
accounting, from meta tensors (shape and dtype, no storage):

* ``memory.argument_size_in_bytes``: the bytes one device holds of the
  step's arguments, each leaf's shard by
  :func:`repro_torch.parallel.sharding.shard_bytes` under the reference's
  pspecs: train is params, the AdamW state (ZeRO-1) and the batch; prefill
  is params and batch; decode is params, cache and the (B, 1) tokens. This
  is XLA's ``argument_size_in_bytes`` of the same cell, to the byte; its
  parts are in ``bytes_by_part``. The optimizer's ``step`` is an int32
  scalar there, as the reference passes it; the port keeps it on the host.
* ``memory.output_size_in_bytes``: the same for the step's outputs
  (:func:`output_bytes`): train returns params and AdamW state placed as
  its arguments and three fp32 scalar metrics; prefill returns logits and
  a cache, decode logits and the new cache. XLA also counts the output
  tuple's table, 8 bytes a leaf. The reference donates no argument, so
  ``alias_size_in_bytes`` is 0 and a device holds arguments and outputs
  at once at the step's end.
* ``flops``: the matmul and convolution FLOPs of the port's own step on
  meta tensors (:class:`MatmulFlops`: ``FlopCounterMode``'s formulas,
  2 M N K a product), with ``use_kernels=False`` (the kernel wrappers
  launch or raise and have no meta path; the reference never reads
  ``use_kernels``): train is ``make_train_step``'s loss, gradients
  (``cfg.remat`` as configured, the recomputed forward included) and
  AdamW; prefill is ``model.prefill(params, batch, max_len=seq_len)``;
  decode is ``model.decode_step`` on ``model.cache_specs``. The count is of
  the whole step across all devices, beside ``n_devices``: without a
  partitioner there is no per-device count to give. Elementwise work is
  not counted (the reference's ``flops``, XLA's cost analysis, is per
  device and counts it).
* ``collectives``, ``bytes_accessed`` and ``memory.temp_size_in_bytes``
  are ``null``: the port runs no collective on these cells, and has no
  compiled program to read bytes from nor an allocator on meta tensors.

The FLOPs are affine in depth, so they are counted on one and two layers
(Whisper: three points over its two stacks; RecurrentGemma: its
(rec, rec, attn) period) and extrapolated (:func:`depth_variants`,
:func:`extrapolate`), as the reference does. RWKV-6's counted FLOPs are
all per-token products, affine in the sequence length, and its portable
WKV is a Python loop over time; its train and prefill counts are also
taken at two short lengths and fitted to the cell's (:func:`time_points`).
The count does not depend on the mesh, so ``main`` takes it once per
(arch, shape). Nothing here allocates on a device or initialises CUDA.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, get_config, list_configs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import build_model, input_specs
from repro_torch.parallel import sharding as sh
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import TrainConfig, init_train_state, make_train_step

OUT_DIR = "results/dryrun_torch"
COLLECTIVES_NOTE = ("null: the port runs no collective on these cells (one controller, "
                    "no partitioner), and XLA's HLO collective bytes have no counterpart")
TEMP_NOTE = "null: meta execution has no allocator"
BYTES_ACCESSED_NOTE = "null: XLA's cost analysis of a compiled program; the port compiles none"
OUTPUT_NOTE = ("train's outputs are placed as the reference's out_shardings place them; "
               "prefill's outputs and decode's logits the reference leaves to XLA, and "
               "the port places them by cache_pspecs and logits_pspec")
FLOPS_NOTE = ("matmul and convolution FLOPs (FlopCounterMode's formulas) of the whole step "
              "on meta tensors, use_kernels=False: the global count across all devices, "
              "not per device, and no elementwise work")
# XLA's output tuple holds one 8-byte buffer pointer a leaf
TUPLE_ENTRY_BYTES = 8
# the two sequence lengths of the time fit
TIME_POINTS = (64, 128)
# the longest sequence the leaves a step reads are traced at
READS_SEQ = 64


def train_state_specs(params_specs: dict) -> dict:
    """The AdamW state as the step takes it: fp32 moments beside every
    parameter, and the step count as the reference's int32 scalar (the
    port's ``init_state`` keeps it as a host int)."""
    def f32(s):
        return torch.empty(s.shape, dtype=torch.float32, device="meta")

    return {"opt": {"m": {k: f32(s) for k, s in params_specs.items()},
                    "v": {k: f32(s) for k, s in params_specs.items()},
                    "step": torch.empty((), dtype=torch.int32, device="meta")}}


def depth_variants(cfg: ArchConfig):
    """Reduced-depth overrides for the affine fit, their names and the full
    depths: layers 1 and 2; Whisper's (decoder, encoder) at (1, 1), (2, 1)
    and (1, 2); RecurrentGemma one and two (rec, rec, attn) periods plus
    its tail."""
    fam = cfg.family
    if fam == "audio":
        return ([dict(n_layers=1, n_encoder_layers=1), dict(n_layers=2, n_encoder_layers=1),
                 dict(n_layers=1, n_encoder_layers=2)],
                ("dec", "enc"), (cfg.n_layers, cfg.n_encoder_layers))
    if fam == "hybrid":
        tail = cfg.n_layers - 3 * (cfg.n_layers // 3)
        return ([dict(n_layers=3 + tail), dict(n_layers=6 + tail)],
                ("period",), (cfg.n_layers // 3,))
    return [dict(n_layers=1), dict(n_layers=2)], ("layer",), (cfg.n_layers,)


def extrapolate(points: list[dict], depths: tuple[int, ...]) -> dict:
    """Every numeric metric at full depth: ``f(1) + sum_i (full_i - 1) *
    (f(point i+1) - f(1))``, slopes clamped at 0 (cost does not fall with
    depth). Integers stay integers."""
    out = {}
    for k, base in points[0].items():
        if not isinstance(base, (int, float)):
            continue
        total = base
        for i, full in enumerate(depths):
            total += (full - 1) * max(0, points[i + 1][k] - base)
        out[k] = total
    return out


def time_points(cfg: ArchConfig, shape: ShapeSpec):
    """The sequence lengths a cell's count is fitted over, or None where it
    is counted at the cell's own length: RWKV-6's train and prefill."""
    if cfg.family == "ssm" and shape.kind in ("train", "prefill"):
        return TIME_POINTS
    return None


class _Reads(TorchDispatchMode):
    """The tensors a step's arithmetic reads: every input of an operation
    that is not a view, traced back through views (select, slice, detach,
    transpose, ...) to the tensor they were taken of. Taking a view is no
    read, so a layer's slice of a leaf the step never uses (Whisper's
    cross-attention K/V weights at decode) does not count, as XLA drops
    what its program does not use."""

    def __init__(self):
        super().__init__()
        self.read: set[int] = set()
        self._root: dict[int, tuple] = {}  # id(view): (view kept alive, id(root))

    def _root_of(self, t: torch.Tensor) -> int:
        hit = self._root.get(id(t))
        return hit[1] if hit else id(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for a in (*args, *kwargs.values())
               for t in (a if isinstance(a, (list, tuple)) else (a,))
               if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        if func.is_view and ins:
            root = self._root_of(ins[0])
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                self._root[id(t)] = (t, root)
        else:
            self.read.update(self._root_of(t) for t in ins)
        return out


class MatmulFlops(TorchDispatchMode):
    """The FLOPs of every operation that ``FlopCounterMode`` has a formula
    for (matrix products, convolutions and their backward, attention), by
    its own formulas (``torch.utils.flop_counter.flop_registry``), summed
    in ``flops``. ``FlopCounterMode`` gives the same total, but first tries
    to decompose every other operation, which on meta tensors takes it
    about two thirds longer again."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


def _leaves(tree, kind=torch.Tensor, path=()):
    """(dotted path, leaf) pairs of the ``kind`` leaves of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, kind, path + (k,))
        elif isinstance(v, kind):
            yield ".".join(path + (k,)), v


def step_call(cfg: ArchConfig, shape: ShapeSpec):
    """One step of the cell on meta tensors: ``(thunk, arguments)``, the
    arguments by part as the reference's step takes them (``params``,
    ``opt``, ``cache``, ``batch``)."""
    cfg = cfg.replace(use_kernels=False)
    model = build_model(cfg)
    params = model.specs()
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=1e-4))
        step = make_train_step(model, tcfg)
        state = init_train_state(model, params, tcfg)
        return (lambda: step(params, state, batch),
                {"params": params, "opt": state["opt"], "batch": batch})
    if shape.kind == "prefill":
        return (lambda: model.prefill(params, batch, max_len=shape.seq_len),
                {"params": params, "batch": batch})
    cache = model.cache_specs(shape.global_batch, shape.seq_len)
    return (lambda: model.decode_step(params, cache, batch["tokens"]),
            {"params": params, "cache": cache, "batch": {"tokens": batch["tokens"]}})


def count_flops(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """The matmul FLOPs (:class:`MatmulFlops`) of one step of the cell at
    ``cfg``'s depth, as it is (no fit)."""
    call, _ = step_call(cfg, shape)
    with MatmulFlops() as counter:
        call()
    return int(counter.flops)


def step_trace(cfg: ArchConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """``(reads, outputs)`` of a step of the cell: the paths of the
    argument leaves it reads, by part, and what :func:`output_bytes` needs
    of its outputs (train: the metric names; prefill and decode: the
    logits, (B, 1, V) at any length). Neither depends on the depth or the
    length (the paths are the same), so the step is traced on the first
    depth variant at a length of at most ``READS_SEQ``."""
    cfg = cfg.replace(**depth_variants(cfg)[0][0])
    call, args = step_call(cfg, dataclasses.replace(
        shape, seq_len=min(shape.seq_len, READS_SEQ)))
    with _Reads() as reads:
        out = call()
    if shape.kind == "train":
        outputs = {"metrics": sorted(out[2])}
    else:
        outputs = {"logits": out[0]}
    return ({part: sorted(path for path, t in _leaves(tree) if id(t) in reads.read)
             for part, tree in args.items()}, outputs)


def time_fit(cfg: ArchConfig, shape: ShapeSpec, lengths) -> tuple[int, dict]:
    """The count at ``shape.seq_len`` from the counts at two shorter
    lengths, exact for a count affine in the length (raises if the slope
    is not a whole number of FLOPs)."""
    (t1, t2) = lengths
    f1, f2 = (count_flops(cfg, dataclasses.replace(shape, seq_len=t)) for t in (t1, t2))
    slope, rest = divmod(f2 - f1, t2 - t1)
    if rest:
        raise ValueError(f"{cfg.name} {shape.name}: counts {f1}, {f2} at T = {t1}, {t2} "
                         "are not affine in T")
    return f1 + (shape.seq_len - t1) * slope, {"lengths": [t1, t2], "flops": [f1, f2]}


def step_flops(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The cell's step FLOPs at full depth, through the depth fit (and the
    time fit where :func:`time_points` asks for it); ``reads`` and
    ``outputs`` (:func:`step_trace`); and ``trace_s``, the seconds the two
    took."""
    t0 = time.perf_counter()
    variants, names, full = depth_variants(cfg)
    lengths = time_points(cfg, shape)
    points, time_fits = [], []
    for ov in variants:
        v = cfg.replace(**ov)
        if lengths:
            f, fit = time_fit(v, shape, lengths)
            time_fits.append(fit)
        else:
            f = count_flops(v, shape)
        points.append({"flops": f})
    reads, outputs = step_trace(cfg, shape)
    return {"flops": extrapolate(points, full)["flops"],
            "depth_fit": {"names": list(names), "full": list(full), "points": points},
            "time_fit": time_fits or None, "reads": reads, "outputs": outputs,
            "trace_s": time.perf_counter() - t0}


def argument_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh,
                   reads: dict | None = None) -> tuple[int, dict]:
    """Per-device bytes of the step's arguments on ``mesh``, and by part.
    ``reads`` (:func:`step_trace`) keeps the leaves the step reads, as
    ``jax.jit`` keeps only the arguments its program uses (the optimizer's
    step count is always read); ``None`` keeps every leaf."""
    model = build_model(cfg)
    params = model.specs()

    def total(part: str, specs: dict, pspecs: dict, prefix: str = "") -> int:
        keep = None if reads is None else set(reads.get(part, ()))
        placed = dict(_leaves(pspecs, sh.P))
        return sum(sh.shard_bytes(t, placed[path], mesh) for path, t in _leaves(specs)
                   if keep is None or prefix + path in keep)

    parts = {"params": total("params", params, sh.param_pspecs(model, cfg, mesh))}
    if shape.kind == "decode":
        cache = model.cache_specs(shape.global_batch, shape.seq_len)
        parts["cache"] = total("cache", cache,
                               sh.cache_pspecs(model, cfg, mesh, shape.global_batch))
        tokens = {"tokens": input_specs(cfg, shape)["tokens"]}
        parts["batch"] = total("batch", tokens, {"tokens": sh.P(
            sh.dp_axes_for(mesh, shape.global_batch), None)})
    else:
        if shape.kind == "train":
            st = train_state_specs(params)["opt"]
            opt_ps = sh.optimizer_pspecs(model, cfg, mesh)
            parts["opt.m"] = total("opt", st["m"], opt_ps["m"], "m.")
            parts["opt.v"] = total("opt", st["v"], opt_ps["v"], "v.")
            parts["opt.step"] = sh.shard_bytes(st["step"], opt_ps["step"], mesh)
        parts["batch"] = total("batch", input_specs(cfg, shape),
                               sh.batch_pspecs(cfg, shape, mesh))
    return sum(parts.values()), parts


def output_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh, outputs: dict) -> tuple[int, dict]:
    """Per-device bytes of the step's outputs on ``mesh``, and by part, as
    XLA's ``output_size_in_bytes`` counts them. Train returns every
    parameter and the AdamW state, placed as the arguments (the
    reference's out_shardings), and its metrics (``outputs``, from
    :func:`step_trace`), each an fp32 scalar on every device (the port
    keeps ``lr`` on the host). Prefill returns the logits and a cache of
    ``seq_len`` positions (and the VLM's patches), decode the logits and
    the new cache; the cache is placed
    by ``cache_pspecs``, the logits by ``logits_pspec``. The reference
    fixes the decode cache's placement, and leaves the logits and the
    prefill cache to XLA, which may place them otherwise (ROADMAP C-ref-15).
    ``tuple_table`` is the output tuple's pointer a leaf."""
    model = build_model(cfg)
    params = model.specs()

    def placed(specs: dict, pspecs: dict) -> tuple[int, int]:
        at = dict(_leaves(pspecs, sh.P))
        leaves = list(_leaves(specs))
        return sum(sh.shard_bytes(t, at[path], mesh) for path, t in leaves), len(leaves)

    scalar = torch.empty((), dtype=torch.float32, device="meta")
    parts, n_leaves = {}, 0
    if shape.kind == "train":
        st = train_state_specs(params)["opt"]
        opt_ps = sh.optimizer_pspecs(model, cfg, mesh)
        for name, specs, ps in (("params", params, sh.param_pspecs(model, cfg, mesh)),
                                ("opt.m", st["m"], opt_ps["m"]),
                                ("opt.v", st["v"], opt_ps["v"])):
            parts[name], n = placed(specs, ps)
            n_leaves += n
        parts["opt.step"] = sh.shard_bytes(st["step"], opt_ps["step"], mesh)
        parts["metrics"] = len(outputs["metrics"]) * sh.shard_bytes(scalar, sh.P(), mesh)
        n_leaves += 1 + len(outputs["metrics"])
    else:
        logits = outputs["logits"]
        parts["logits"] = sh.shard_bytes(
            logits, sh.P(*sh.logits_pspec(cfg, mesh)[:logits.dim()]), mesh)
        # a prefill's cache holds the vision tokens too (the VLM's patches)
        length = shape.seq_len + (cfg.n_patches if cfg.is_vlm and shape.kind == "prefill"
                                  else 0)
        parts["cache"], n = placed(model.cache_specs(shape.global_batch, length),
                                   sh.cache_pspecs(model, cfg, mesh, shape.global_batch))
        n_leaves += 1 + n
    parts["tuple_table"] = TUPLE_ENTRY_BYTES * n_leaves
    return sum(parts.values()), parts


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str = OUT_DIR,
             flops: dict | None = None) -> dict:
    """One cell: its bytes on the production mesh, its FLOPs (``flops``: a
    :func:`step_flops` result to reuse, else counted here), written to
    ``<out_dir>/<arch>__<shape>__<mesh>.json``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if flops is None:
        flops = step_flops(cfg, shape)
    arg_bytes, parts = argument_bytes(cfg, shape, mesh, flops["reads"])
    out_bytes, out_parts = output_bytes(cfg, shape, mesh, flops["outputs"])
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
        "ok": True,
        "flops": flops["flops"], "flops_note": FLOPS_NOTE,
        "memory": {"argument_size_in_bytes": arg_bytes, "bytes_by_part": parts,
                   # leaves the step never reads (Whisper's encoder at decode)
                   "unread_bytes": argument_bytes(cfg, shape, mesh)[0] - arg_bytes,
                   "output_size_in_bytes": out_bytes, "output_bytes_by_part": out_parts,
                   "output_note": OUTPUT_NOTE, "alias_size_in_bytes": 0,
                   "temp_size_in_bytes": None, "temp_note": TEMP_NOTE},
        "bytes_accessed": None, "bytes_accessed_note": BYTES_ACCESSED_NOTE,
        "collectives": None, "collectives_note": COLLECTIVES_NOTE,
        "depth_fit": flops["depth_fit"], "time_fit": flops["time_fit"],
        "n_devices": mesh.size, "mesh_shape": mesh.shape,
        "trace_s": flops["trace_s"],
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[dryrun] OK {arch} {shape_name} {mesh_name} flops={result['flops']:.3e} "
          f"arg={arg_bytes / 1e9:.3f}GB/device out={out_bytes / 1e9:.3f}GB/device "
          f"trace={result['trace_s']:.1f}s", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in [args.shape] if args.shape else cfg.shapes:
            if shape_name not in cfg.shapes:
                print(f"[dryrun] SKIP {arch} {shape_name} (not applicable)")
                continue
            flops = None  # mesh-independent: counted once for both meshes
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                path = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] cached {path}")
                    continue
                try:
                    if flops is None:
                        flops = step_flops(cfg, SHAPES[shape_name])
                    run_cell(arch, shape_name, mp, args.out, flops=flops)
                except Exception as e:  # noqa: BLE001 — record, go on, exit non-zero
                    failures.append((arch, shape_name, mesh_name, repr(e)))
                    traceback.print_exc()
    print(f"[dryrun] cuda_initialized={torch.cuda.is_initialized()}", flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        raise SystemExit(1)
    print("[dryrun] all cells green")


if __name__ == "__main__":
    main()
