"""The port imports torch and numpy — never jax, never the reference package.

Checked two ways: an AST walk over every source file of the port (and
``chip_smoke.py``), and a subprocess whose import system refuses ``jax`` and
``repro`` outright while it imports every module of ``repro_torch``.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_package_layout_mirrors_the_reference():
    for sub in ("core", "codec", "nn", "train", "kernels", "data", "models",
                "serve", "testing", "parallel", "configs", "launch", "analysis"):
        assert (PKG / sub / "__init__.py").is_file(), sub
    for src in ("gbatc_kernels.cu", "flash_attention.cu", "block_quant.cu",
                "rglru_scan.cu", "rwkv6_scan.cu"):
        assert (PKG / "kernels" / "csrc" / src).is_file(), src
    assert (ROOT / "chip_smoke.py").is_file()


def test_no_jax_or_reference_import_in_sources():
    bad = [
        f"{path.relative_to(ROOT)}:{line} imports {root}"
        for path in _sources()
        for root, line in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_cuda_sources_do_not_include_torch_headers():
    for src in (PKG / "kernels" / "csrc").glob("*.cu"):
        assert "torch/" not in src.read_text(), src.name


_BLOCKED_IMPORT_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import block_attention, common
assert "repro_torch.models.block_attention" in names
assert "repro_torch.kernels.flash_attention" in names
for mod in ("block_quant", "rglru_scan", "rwkv6_scan"):
    assert f"repro_torch.kernels.{mod}" in names, mod
for mod in ("codec.partial", "codec.integrity", "testing.faults",
            "serve.decode_service", "train.fault_tolerance", "core.sz",
            "core.gae_ref", "core.qoi", "parallel", "parallel.mesh_fit",
            "parallel.gradient_compression"):
    assert f"repro_torch.{mod}" in names, mod
for mod in ("configs", "configs.base", "nn.module", "models.common",
            "models.transformer", "models.rwkv6", "models.rglru", "models.whisper",
            "models.registry", "serve.kvcache", "serve.serve_loop", "launch",
            "launch.serve", "launch.mesh", "launch.dryrun", "parallel.sharding"):
    assert f"repro_torch.{mod}" in names, mod
from repro_torch.configs.base import list_configs
for arch in list_configs():
    assert f"repro_torch.configs.{arch}" in names, arch
for op in ("flash_attention_op", "rwkv6_scan_op", "rglru_scan_op",
           "block_quant_op", "gbatc_project_op", "gbatc_correct_op"):
    assert callable(getattr(ops, op)), op
print(len(names))
"""


def test_every_module_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT_SCRIPT],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 32


def test_importing_builds_nothing():
    """Kernels are built at first launch, never at import."""
    from repro_torch.kernels import _build, block_quant, flash_attention, gbatc_project  # noqa: F401
    from repro_torch.kernels import ops, rglru_scan, rwkv6_scan  # noqa: F401

    assert _build.build_info() == {}


@pytest.mark.parametrize("entry", ["codec", "pipeline", "engine", "decompress", "ops",
                                   "attention_codec", "flash_ops", "flash_attention_op",
                                   "rwkv6_scan_op", "rglru_scan_op", "block_quant_op",
                                   "gbatc_project_op", "gbatc_correct_op",
                                   "partial_decoder", "salvage", "decompress_reference",
                                   "decode_service", "production_rates",
                                   "production_rates_np", "mesh", "sharded_engine",
                                   "lm_init", "lm_make_batch", "lm_server",
                                   "lm_from_reference", "quantized_kv_cache"])
def test_device_none_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    from repro_torch import codec
    from repro_torch.core import gae
    from repro_torch.core.pipeline import GBATCCodec, GBATCPipeline, PipelineConfig
    from repro_torch.core import qoi
    from repro_torch.kernels import ops
    from repro_torch.parallel import Mesh, mesh_fit
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model, make_batch
    from repro_torch.serve import DecodeService, Server
    from repro_torch.serve.kvcache import QuantizedKVCache

    lm_cfg = get_config("llama3_2_1b").smoke()
    calls = {
        "lm_init": lambda: build_model(lm_cfg).init(0),
        "lm_make_batch": lambda: make_batch(lm_cfg, batch=1, seq=4, kind="prefill"),
        "lm_server": lambda: Server(build_model(lm_cfg), {}),
        "lm_from_reference": lambda: convert.lm_from_reference(
            {"embed": np.zeros((2, 2), np.float32)}),
        "quantized_kv_cache": lambda: QuantizedKVCache.create(1, 1, 4, 1, 8),
        "codec": lambda: GBATCCodec(PipelineConfig()),
        "pipeline": lambda: GBATCPipeline(PipelineConfig(), n_species=4),
        "engine": lambda: gae.GuaranteeEngine(),
        "decompress": lambda: codec.decompress(b"GBTC"),
        "partial_decoder": lambda: codec.PartialDecoder(b"GBTC"),
        "salvage": lambda: codec.salvage_decompress(b"GBTC"),
        "decompress_reference": lambda: codec.decompress_reference(b"GBTC"),
        "decode_service": lambda: DecodeService(),
        "mesh": lambda: Mesh((None,)),
        "sharded_engine": lambda: mesh_fit.ShardedGuaranteeEngine(),
        "production_rates": lambda: qoi.production_rates(
            qoi.make_mechanism(4), np.ones((2, 4), np.float32),
            np.ones(2, np.float32)),
        "production_rates_np": lambda: qoi.production_rates_np(
            qoi.make_mechanism(4), np.ones((4, 1, 2, 2), np.float32),
            np.ones((1, 2, 2), np.float32)),
        "ops": lambda: ops.gbatc_correct_batched(
            np.zeros((1, 2, 4), np.float32), np.zeros((1, 2, 4), np.float32),
            np.zeros((1, 4, 4), np.float32)),
        "attention_codec": lambda: GBATCCodec(PipelineConfig(family="attention")),
        "flash_ops": lambda: ops.flash_attention(
            *[np.zeros((1, 1, 4, 8), np.float32)] * 3),
        "flash_attention_op": lambda: ops.flash_attention_op(
            *[np.zeros((1, 1, 4, 8), np.float32)] * 3),
        "rwkv6_scan_op": lambda: ops.rwkv6_scan_op(
            *[np.zeros((1, 2, 1, 4), np.float32)] * 4, np.zeros((1, 4), np.float32)),
        "rglru_scan_op": lambda: ops.rglru_scan_op(*[np.zeros((1, 2, 4), np.float32)] * 2),
        "block_quant_op": lambda: ops.block_quant_op(np.zeros((2, 64), np.float32)),
        "gbatc_project_op": lambda: ops.gbatc_project_op(
            np.zeros((2, 4), np.float32), np.zeros((4, 4), np.float32)),
        "gbatc_correct_op": lambda: ops.gbatc_correct_op(
            *[np.zeros((2, 4), np.float32)] * 3, np.zeros((4, 4), np.float32)),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
