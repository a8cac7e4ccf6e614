"""The port's dry run (``repro_torch.launch.dryrun``): per-device bytes
against XLA's, step FLOPs against the reference's step and a real one, the
depth and time fits against the direct count, and the CLI.

* Bytes: the reference's own ``launch/dryrun.py::_lower_compile`` lowers
  and compiles each cell on a forced 8-device CPU host, in one subprocess;
  its ``memory_analysis()`` argument and output sizes must equal the
  port's accounting to the byte. The cells are each family's ``.smoke()``
  config x train / prefill / decode (seq 64, batch 8) on a (4, 2) mesh,
  and Llama's train cell on (2, 4) and (8, 1).
* FLOPs against the reference: 2 M N K over every ``dot_general`` and
  convolution of the reference step's jaxpr (``jax.make_jaxpr`` of
  ``make_train_step`` / ``prefill`` / ``decode_step``; a scan's body times
  its length, remat bodies as they stand) equals the port's meta count:
  every config's ``.smoke()`` x each kind, each family's train step under
  ``remat`` "full" and "dots", the chunked attention path, and the
  full-width Llama-3.2-1B cells ``chip_smoke.py`` runs on the card.
* FLOPs against a real step: the meta count equals ``FlopCounterMode``
  over the same step on real CPU tensors, every config's ``.smoke()``,
  each kind.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.registry import build_model, make_batch
from repro_torch.parallel import sharding as sh
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import TrainConfig, init_train_state, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "llama3_2_1b", "moe": "qwen3_moe_30b_a3b", "vlm": "qwen2_vl_7b",
            "audio": "whisper_base", "ssm": "rwkv6_7b", "hybrid": "recurrentgemma_2b"}
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 8
BYTE_CELLS = ([(arch, kind, (4, 2)) for arch in FAMILIES.values() for kind in KINDS]
              + [("llama3_2_1b", "train", (2, 4)), ("llama3_2_1b", "train", (8, 1))])

_REFERENCE_SCRIPT = r"""
import json, sys
import jax
jax.devices()  # 8 forced host devices, locked before the dry run's import
from repro.configs.base import ShapeSpec, get_config
from repro.launch.dryrun import _lower_compile
from repro.launch.mesh import make_mesh
out = {}
for arch, kind, mesh_shape in json.loads(sys.argv[1]):
    cfg = get_config(arch).smoke()
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
    shape = ShapeSpec(kind, %(seq)d, %(batch)d, kind)
    mem = _lower_compile(cfg, shape, mesh)["memory"]
    out[f"{arch}/{kind}/{tuple(mesh_shape)}"] = mem
print(json.dumps(out))
""" % {"seq": SEQ, "batch": BATCH}


@pytest.fixture(scope="module", autouse=True)
def reference_compile():
    """The reference's compiles, started with the module's first test and
    read by the byte tests at its end, so that they overlap the rest."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_SCRIPT, json.dumps(BYTE_CELLS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    proc.kill()
    proc.communicate()


def _cell_id(cell):
    arch, kind, mesh = cell
    return f"{arch}-{kind}-{mesh[0]}x{mesh[1]}"


def _jaxpr_dot_flops(jaxpr) -> int:
    """2 M N K over every ``dot_general`` and convolution of a jaxpr and the
    jaxprs inside it (jit, remat, custom derivatives: once), a scan's body
    times its length."""
    from jax.extend import core as jcore

    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += (2 * math.prod(eqn.outvars[0].aval.shape)
                      * math.prod(lhs[i] for i in contract))
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            per_out = math.prod(rhs) // rhs[eqn.params["dimension_numbers"].rhs_spec[0]]
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * per_out
        else:
            inner = sum(_jaxpr_dot_flops(j.jaxpr if isinstance(j, jcore.ClosedJaxpr) else j)
                        for v in eqn.params.values()
                        for j in (v if isinstance(v, (list, tuple)) else (v,))
                        if isinstance(j, (jcore.ClosedJaxpr, jcore.Jaxpr)))
            if inner and name in ("while", "cond"):
                raise NotImplementedError(f"products inside {name}: no trip count")
            total += inner * (eqn.params["length"] if name == "scan" else 1)
    return total


def reference_flops(arch: str, shape: ShapeSpec, smoke: bool = True, **overrides) -> int:
    """The matmul FLOPs of the reference's own step of the cell, from its
    jaxpr (no device, no compile)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as ref_config
    from repro.models.registry import build_model as ref_model
    from repro.models.registry import input_specs as ref_inputs
    from repro.train import optimizer as ref_opt
    from repro.train.train_loop import TrainConfig as RefTrainConfig
    from repro.train.train_loop import make_train_step as ref_train_step

    cfg = ref_config(arch)
    cfg = (cfg.smoke() if smoke else cfg).replace(**overrides)
    model = ref_model(cfg)
    params, batch = model.specs(), ref_inputs(cfg, shape)
    if shape.kind == "train":
        f32 = lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32)  # noqa: E731
        state = {"opt": {"m": jax.tree.map(f32, params), "v": jax.tree.map(f32, params),
                         "step": jax.ShapeDtypeStruct((), jnp.int32)}}
        step = ref_train_step(model, RefTrainConfig(optimizer=ref_opt.AdamWConfig(lr=1e-4)))
        closed = jax.make_jaxpr(step)(params, state, batch)
    elif shape.kind == "prefill":
        closed = jax.make_jaxpr(lambda p, b: model.prefill(p, b, max_len=shape.seq_len))(
            params, batch)
    else:
        cache = model.cache_specs(shape.global_batch, shape.seq_len)
        closed = jax.make_jaxpr(model.decode_step)(params, cache, batch["tokens"])
    return _jaxpr_dot_flops(closed.jaxpr)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_configs())
def test_meta_flops_equal_the_reference_jaxpr(arch, kind):
    shape = ShapeSpec(kind, 32, 2, kind)
    want = reference_flops(arch, shape)
    assert want > 0
    assert dryrun.count_flops(get_config(arch).smoke(), shape) == want


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_remat_flops_equal_the_reference_jaxpr(arch, remat):
    """The recomputed forward counts as the reference's remat bodies do."""
    shape = ShapeSpec("train", 32, 2, "train")
    cfg = get_config(arch).smoke().replace(remat=remat)
    got = dryrun.count_flops(cfg, shape)
    assert got == reference_flops(arch, shape, remat=remat)
    if remat == "full":  # the forward's products once more
        assert got > dryrun.count_flops(cfg.replace(remat="none"), shape)


@pytest.mark.parametrize("arch,kind", [("llama3_2_1b", "prefill"), ("llama3_2_1b", "train"),
                                       ("recurrentgemma_2b", "prefill")])
def test_chunked_attention_flops_equal_the_reference_jaxpr(arch, kind):
    """Past 4096 positions attention runs in (512, 1024) chunks: the port's
    loops against the reference's nested scans (RecurrentGemma: its
    sliding window)."""
    shape = ShapeSpec(kind, 4608, 1, kind)
    assert dryrun.count_flops(get_config(arch).smoke(), shape) == reference_flops(arch, shape)


# chip_smoke.py's dryrun_path cells: lm_train_path's Llama-3.2-1B at full
# width (remat full, batch 4, seq 2048) and its decode step on a 4096 cache
CHIP_CELLS = {"train": ShapeSpec("train", 2048, 4, "train"),
              "decode": ShapeSpec("decode", 4096, 4, "decode")}


@pytest.mark.parametrize("kind", list(CHIP_CELLS))
def test_full_width_dry_run_flops_equal_the_reference_jaxpr(kind):
    """The dry run's count, through its depth fit, of the cells whose count
    ``chip_smoke.py`` holds to a real step on the card."""
    shape = CHIP_CELLS[kind]
    got = dryrun.step_flops(get_config("llama3_2_1b").replace(remat="full"), shape)["flops"]
    assert got == reference_flops("llama3_2_1b", shape, smoke=False, remat="full")


@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_one_device_bytes_are_the_real_state_storage(arch):
    """On a (1, 1) mesh the accounted train bytes are the storage of the
    real state (params, AdamW moments, batch) the port builds, plus the
    step count's int32 that the port keeps on the host."""
    cfg = get_config(arch).smoke().replace(use_kernels=False)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    state = init_train_state(model, params, TrainConfig())
    batch = make_batch(cfg, batch=BATCH, seq=SEQ, kind="train", device="cpu")
    tensors = [*params.values(), *state["opt"]["m"].values(), *state["opt"]["v"].values(),
               *batch.values()]
    storage = sum(t.untyped_storage().nbytes() for t in tensors)
    shape, one = ShapeSpec("train", SEQ, BATCH, "train"), make_mesh((1, 1), ("data", "model"))
    got, parts = dryrun.argument_bytes(cfg, shape, one)
    assert state["opt"]["step"] == 0 and parts["opt.step"] == 4
    assert storage == got - parts["opt.step"]
    # the outputs: the port's step count and learning rate are host numbers
    new_params, new_state, metrics = make_train_step(model, TrainConfig())(params, state, batch)
    out_storage = sum(t.untyped_storage().nbytes() for t in (
        *new_params.values(), *new_state["opt"]["m"].values(),
        *new_state["opt"]["v"].values(), *metrics.values()) if isinstance(t, torch.Tensor))
    _, outputs = dryrun.step_trace(cfg, shape)
    out, out_parts = dryrun.output_bytes(cfg, shape, one, outputs)
    assert sorted(metrics) == outputs["metrics"] == ["grad_norm", "loss", "lr"]
    assert not isinstance(metrics["lr"], torch.Tensor) and new_state["opt"]["step"] == 1
    assert out_storage == out - out_parts["tuple_table"] - out_parts["opt.step"] - 4


def _real_cache(specs, length):
    if isinstance(specs, dict):
        return {k: _real_cache(v, length) for k, v in specs.items()}
    if specs.dim() == 0:
        return torch.tensor(length, dtype=specs.dtype)
    return torch.zeros(specs.shape, dtype=specs.dtype)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_one_device_output_bytes_are_the_real_output_storage(arch, kind):
    """On a (1, 1) mesh the accounted output bytes, less the tuple's
    table, are the storage of the logits and cache a real step returns."""
    cfg = get_config(arch).smoke().replace(use_kernels=False)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    shape = ShapeSpec(kind, SEQ, BATCH, kind)
    if kind == "prefill":
        batch = make_batch(cfg, batch=BATCH, seq=SEQ, kind="prefill", device="cpu")
        logits, cache = model.prefill(params, batch, max_len=SEQ)
    else:
        tokens = make_batch(cfg, batch=BATCH, seq=1, kind="decode", device="cpu")["tokens"]
        logits, cache = model.decode_step(
            params, _real_cache(model.cache_specs(BATCH, SEQ), SEQ // 2), tokens)
    storage = logits.untyped_storage().nbytes() + sum(
        t.untyped_storage().nbytes() for _, t in dryrun._leaves(cache))
    _, outputs = dryrun.step_trace(cfg, shape)
    got, parts = dryrun.output_bytes(cfg, shape, make_mesh((1, 1), ("data", "model")), outputs)
    assert outputs["logits"].shape == logits.shape
    assert storage == got - parts["tuple_table"]


def _real_flops(cfg, shape) -> int:
    """FlopCounterMode over the cell's step on real CPU tensors."""
    cfg = cfg.replace(use_kernels=False)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tcfg = TrainConfig(optimizer=opt.AdamWConfig(lr=1e-4))
        step, state = make_train_step(model, tcfg), init_train_state(model, params, tcfg)
        batch = make_batch(cfg, batch=b, seq=t, kind="train", device="cpu")
        call = lambda: step(params, state, batch)  # noqa: E731
    elif shape.kind == "prefill":
        batch = make_batch(cfg, batch=b, seq=t, kind="prefill", device="cpu")
        call = lambda: model.prefill(params, batch, max_len=t)  # noqa: E731
    else:
        cache = _real_cache(model.cache_specs(b, t), t // 2)
        tokens = make_batch(cfg, batch=b, seq=1, kind="decode", device="cpu")["tokens"]
        call = lambda: model.decode_step(params, cache, tokens)  # noqa: E731
    with FlopCounterMode(display=False) as counter:
        call()
    return int(counter.get_total_flops())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_configs())
def test_meta_flops_equal_the_real_step(arch, kind):
    cfg = get_config(arch).smoke()
    shape = ShapeSpec(kind, 32, 2, kind)
    got = dryrun.count_flops(cfg, shape)
    assert got > 0
    assert got == _real_flops(cfg, shape)


# deeper than .smoke(), so that the fit extrapolates: Llama 5 layers, MoE and
# VLM 4, Whisper (3 decoder, 4 encoder), RWKV-6 4, RecurrentGemma 3 periods
# and a tail of 2
DEEP = {"llama3_2_1b": dict(n_layers=5), "qwen3_moe_30b_a3b": dict(n_layers=4),
        "qwen2_vl_7b": dict(n_layers=4), "whisper_base": dict(n_layers=3, n_encoder_layers=4),
        "rwkv6_7b": dict(n_layers=4), "recurrentgemma_2b": dict(n_layers=11)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(DEEP))
def test_depth_fit_equals_the_direct_count(arch, kind):
    cfg = get_config(arch).smoke().replace(**DEEP[arch])
    shape = ShapeSpec(kind, 48, 2, kind)
    fit = dryrun.step_flops(cfg, shape)
    assert fit["flops"] == dryrun.count_flops(cfg, shape)
    assert len(fit["depth_fit"]["points"]) == len(dryrun.depth_variants(cfg)[0])
    assert (fit["time_fit"] is not None) == (arch == "rwkv6_7b" and kind != "decode")


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rwkv6_time_fit_equals_the_direct_count_at_512(kind):
    """RWKV-6 at full width, one layer: the count fitted from T = 64 and 128
    is the count at T = 512."""
    cfg = get_config("rwkv6_7b").replace(n_layers=1)
    shape = ShapeSpec(kind, 512, SHAPES["prefill_32k"].global_batch, kind)
    fitted, points = dryrun.time_fit(cfg, shape, dryrun.TIME_POINTS)
    assert points["lengths"] == list(dryrun.TIME_POINTS)
    assert fitted == dryrun.count_flops(cfg, shape)
    assert fitted == reference_flops("rwkv6_7b", shape, smoke=False, n_layers=1)


def test_extrapolate_is_the_affine_fit():
    assert dryrun.extrapolate([{"flops": 10}, {"flops": 16}], (5,)) == {"flops": 34}
    # two stacks; a falling point is clamped to a zero slope
    pts = [{"flops": 10, "name": "x"}, {"flops": 13}, {"flops": 9}]
    assert dryrun.extrapolate(pts, (3, 4)) == {"flops": 16}


def test_cli_writes_both_meshes_and_leaves_cuda_alone(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "llama3_2_1b", "--shape", "decode_32k",
                          "--mesh", "both", "--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[dryrun] cuda_initialized=False" in out.stdout.splitlines()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["llama3_2_1b__decode_32k__pod16x16.json",
                     "llama3_2_1b__decode_32k__pod2x16x16.json"]
    cfg, shape = get_config("llama3_2_1b"), SHAPES["decode_32k"]
    fit = dryrun.step_flops(cfg, shape)
    for name, multi in zip(files, (False, True)):
        cell = json.loads((tmp_path / name).read_text())
        mesh = make_production_mesh(multi_pod=multi)
        arg, parts = dryrun.argument_bytes(cfg, shape, mesh, fit["reads"])
        assert cell["memory"]["argument_size_in_bytes"] == arg
        assert cell["memory"]["bytes_by_part"] == parts
        assert cell["memory"]["temp_size_in_bytes"] is None
        assert cell["collectives"] is None and cell["collectives_note"]
        assert cell["memory"]["unread_bytes"] == 0  # Llama's decode reads every leaf
        assert cell["flops"] == fit["flops"] and cell["n_devices"] == mesh.size
        assert cell["flops"] == reference_flops("llama3_2_1b", shape, smoke=False)
        out, out_parts = dryrun.output_bytes(cfg, shape, mesh, fit["outputs"])
        assert cell["memory"]["output_size_in_bytes"] == out
        assert cell["memory"]["output_bytes_by_part"] == out_parts
        assert cell["memory"]["alias_size_in_bytes"] == 0 and cell["bytes_accessed"] is None
        assert cell["depth_fit"]["full"] == [cfg.n_layers]
        assert cell["kind"] == "decode" and cell["trace_s"] >= 0


def test_moe_dispatch_runs_on_meta_and_counts_as_bincount():
    cfg = get_config("qwen3_moe_30b_a3b").smoke()
    e, k, d, n = cfg.n_experts, cfg.moe_top_k, cfg.d_model, 40
    p = {"router": torch.empty((d, e), device="meta")}
    top_w, top_i, probs, order, slot, keep = transformer.moe_dispatch(
        cfg, p, torch.empty((n, d), device="meta"))
    assert top_w.shape == top_i.shape == (n, k) and probs.shape == (n, e)
    assert order.shape == slot.shape == keep.shape == (n * k,)
    assert slot.device.type == "meta"
    rng = np.random.default_rng(0)
    for size, hi in [(0, 8), (1, 8), (97, 8), (4096, 3), (1000, 64)]:
        ids = torch.from_numpy(rng.integers(0, hi, size))
        got = transformer.expert_counts(ids, 64)
        want = torch.bincount(ids, minlength=64)
        assert got.dtype == want.dtype and torch.equal(got, want)


# the byte tests last: they wait for the reference's compiles
@pytest.fixture(scope="module")
def xla_memory(reference_compile):
    try:
        stdout, stderr = reference_compile.communicate(timeout=240)
    finally:
        reference_compile.kill()
    assert reference_compile.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", BYTE_CELLS, ids=_cell_id)
def test_argument_bytes_equal_xla(xla_memory, cell):
    arch, kind, mesh_shape = cell
    cfg, shape = get_config(arch).smoke(), ShapeSpec(kind, SEQ, BATCH, kind)
    reads, _ = dryrun.step_trace(cfg, shape)
    got, parts = dryrun.argument_bytes(cfg, shape, make_mesh(mesh_shape, ("data", "model")),
                                       reads)
    assert got == xla_memory[f"{arch}/{kind}/{mesh_shape}"]["argument_size_in_bytes"]
    assert got == sum(parts.values())
    want_parts = {"train": {"params", "opt.m", "opt.v", "opt.step", "batch"},
                  "prefill": {"params", "batch"}, "decode": {"params", "cache", "batch"}}
    assert set(parts) == want_parts[kind]


# Outputs the reference leaves to XLA (out_shardings None: prefill's logits
# and cache, decode's logits) that XLA places otherwise than the port's
# logits_pspec / cache_pspecs (ROADMAP C-ref-15): Whisper's logits stay on
# "data" alone, and its prefill's cross-attention K/V go over "model" by head.
XLA_PLACED = {
    ("whisper_base", "decode"): {"logits": sh.P("data", None, None)},
    ("whisper_base", "prefill"): {"logits": sh.P("data", None, None),
                                  "ck": sh.P(None, "data", None, "model", None),
                                  "cv": sh.P(None, "data", None, "model", None)},
}


@pytest.mark.parametrize("cell", BYTE_CELLS, ids=_cell_id)
def test_output_bytes_equal_xla(xla_memory, cell):
    arch, kind, mesh_shape = cell
    cfg, shape = get_config(arch).smoke(), ShapeSpec(kind, SEQ, BATCH, kind)
    mesh = make_mesh(mesh_shape, ("data", "model"))
    _, outputs = dryrun.step_trace(cfg, shape)
    got, parts = dryrun.output_bytes(cfg, shape, mesh, outputs)
    assert got == sum(parts.values())
    # XLA's placement of what the reference leaves to it, where it differs
    model = build_model(cfg)
    cache, cache_ps = model.cache_specs(BATCH, SEQ), sh.cache_pspecs(model, cfg, mesh, BATCH)
    moved = 0
    for leaf, pspec in XLA_PLACED.get((arch, kind), {}).items():
        t, port = ((outputs["logits"], sh.P(*sh.logits_pspec(cfg, mesh)))
                   if leaf == "logits" else (cache[leaf], cache_ps[leaf]))
        moved += sh.shard_bytes(t, pspec, mesh) - sh.shard_bytes(t, port, mesh)
    mem = xla_memory[f"{arch}/{kind}/{mesh_shape}"]
    assert got + moved == mem["output_size_in_bytes"]
    assert mem["alias_size_in_bytes"] == 0
    want_parts = {"train": {"params", "opt.m", "opt.v", "opt.step", "metrics", "tuple_table"},
                  "prefill": {"logits", "cache", "tuple_table"},
                  "decode": {"logits", "cache", "tuple_table"}}
    assert set(parts) == want_parts[kind]
