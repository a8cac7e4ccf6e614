"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's ``parallel/sharding.py``, leaf by leaf.

Every config at full width (only the parameter definitions are walked),
every shape of ``cfg.shapes``, on the production meshes (16, 16) and
(2, 16, 16) and on (4, 2), (2, 4), (8, 1), (1, 8). The reference runs on
``jax.sharding.AbstractMesh`` (its functions read only the axis names and
sizes), the port on its own :class:`~repro_torch.launch.mesh.LogicalMesh`.
Leaves are paired by the reference's path (``convert._leaves``); two specs
agree when their ``tuple(...)`` do. Plus ``shard_shape`` / ``shard_bytes``,
the ceil-division law of each device's share.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RP

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import get_config as r_get_config
from repro.models.registry import build_model as r_build_model
from repro.nn.module import logical_to_pspec as r_logical_to_pspec
from repro.parallel import sharding as r_sh
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.convert import _leaves
from repro_torch.launch.mesh import LogicalMesh, make_mesh, make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.nn.module import PartitionSpec, logical_to_pspec
from repro_torch.parallel import sharding as sh

ARCHS = list_configs()
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((8, 1), ("data", "model")), ((1, 8), ("data", "model"))]


def _pairs():
    """(port mesh, reference mesh) for every mesh of the sweep."""
    return [(make_mesh(s, a), AbstractMesh(s, a)) for s, a in MESHES]


def _flat(tree) -> dict:
    """{dotted reference path: tuple(spec)} of a nested or flat spec tree."""
    return {".".join(path): tuple(spec) for path, spec in _leaves(tree)}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    cfg, r_cfg = get_config(name), r_get_config(name)
    return name, cfg, r_cfg, build_model(cfg), r_build_model(r_cfg)


def test_make_rules_and_dp_axes(arch):
    _, cfg, r_cfg, _, _ = arch
    for mesh, r_mesh in _pairs():
        assert sh.make_rules(cfg, mesh) == r_sh.make_rules(r_cfg, r_mesh)
        assert sh.dp_axes(mesh) == r_sh.dp_axes(r_mesh)
        assert (sh.tp_size(mesh), sh.dp_size(mesh)) == (r_sh.tp_size(r_mesh),
                                                         r_sh.dp_size(r_mesh))
        for name in cfg.shapes:
            for batch in (1, 2, 3, 8, 16, 32, SHAPES[name].global_batch):
                assert sh.dp_axes_for(mesh, batch) == r_sh.dp_axes_for(r_mesh, batch)


def test_param_pspecs(arch):
    _, cfg, r_cfg, model, r_model = arch
    for mesh, r_mesh in _pairs():
        got = _flat(sh.param_pspecs(model, cfg, mesh))
        want = _flat(r_sh.param_pspecs(r_model, r_cfg, r_mesh))
        assert got == want, mesh
        assert set(got) == set(model.specs())


@pytest.mark.parametrize("zero", [True, False], ids=["zero", "replicated"])
def test_optimizer_pspecs(arch, zero):
    _, cfg, r_cfg, model, r_model = arch
    for mesh, r_mesh in _pairs():
        got = sh.optimizer_pspecs(model, cfg, mesh, zero=zero)
        want = r_sh.optimizer_pspecs(r_model, r_cfg, r_mesh, zero=zero)
        assert set(got) == set(want) == {"m", "v", "step"}
        for part in ("m", "v"):
            assert _flat(got[part]) == _flat(want[part]), (mesh, part)
        assert tuple(got["step"]) == tuple(want["step"]) == ()


def test_cache_pspecs(arch):
    name, cfg, r_cfg, model, r_model = arch
    batches = [0] + [SHAPES[s].global_batch for s in cfg.shapes]
    for mesh, r_mesh in _pairs():
        for batch in batches:
            got = _flat(sh.cache_pspecs(model, cfg, mesh, batch))
            want = _flat(r_sh.cache_pspecs(r_model, r_cfg, r_mesh, batch))
            assert got == want, (mesh, batch)
            # every leaf of the cache has its spec, and no spec is spare
            assert set(got) == {".".join(p) for p, _ in
                                _leaves(model.cache_specs(max(batch, 1), 64))}
    # kv_quant's int8 layout, where the family has one
    if cfg.family in ("dense", "moe", "vlm"):
        q, r_q = cfg.replace(kv_quant=True), r_cfg.replace(kv_quant=True)
        for mesh, r_mesh in _pairs():
            assert (_flat(sh.cache_pspecs(build_model(q), q, mesh, 8))
                    == _flat(r_sh.cache_pspecs(r_build_model(r_q), r_q, r_mesh, 8)))


def test_batch_and_logits_pspecs(arch):
    _, cfg, r_cfg, _, _ = arch
    for mesh, r_mesh in _pairs():
        for name in cfg.shapes:
            got = sh.batch_pspecs(cfg, SHAPES[name], mesh)
            want = r_sh.batch_pspecs(r_cfg, R_SHAPES[name], r_mesh)
            assert {k: tuple(v) for k, v in got.items()} == \
                   {k: tuple(v) for k, v in want.items()}, (mesh, name)
        assert tuple(sh.logits_pspec(cfg, mesh)) == tuple(r_sh.logits_pspec(r_cfg, r_mesh))


def test_zero_pspec_takes_meta_tensors():
    mesh, r_mesh = make_mesh((4, 2), ("data", "model")), AbstractMesh((4, 2), ("data", "model"))
    for shape, spec in [((64, 96), (None, "model")), ((6, 8), (None, None)),
                        ((5, 3), (None,)), ((), ()), ((8, 16), ("data", None)),
                        ((3, 8, 4), (None, None, "model"))]:
        got = sh.zero_pspec(torch.empty(shape, device="meta"), PartitionSpec(*spec), mesh)
        want = r_sh.zero_pspec(jax.ShapeDtypeStruct(shape, jnp.float32), RP(*spec), r_mesh)
        assert tuple(got) == tuple(want), (shape, spec)


def test_partition_spec_normalises_as_the_reference():
    for entries in [(("data",), None), ((), None), (("pod", "data"), None), (),
                    (None, "model"), ("data",), (["pod", "data"], "model")]:
        assert tuple(PartitionSpec(*entries)) == tuple(RP(*entries)), entries
    assert PartitionSpec(("data",), None) == ("data", None)
    rules = {"a": ("pod", "data"), "b": "data", "c": None}
    for axes in [("a", "b"), ("b", "a"), ("c", None, "b"), ()]:
        assert tuple(logical_to_pspec(axes, rules)) == tuple(r_logical_to_pspec(axes, rules))


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.size) == (
        {"data": 16, "model": 16}, ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"), 512)
    with pytest.raises(ValueError):
        LogicalMesh((2, 2), ("data",))
    with pytest.raises(ValueError):
        make_mesh((2, 0), ("data", "model"))


@pytest.mark.parametrize("shape,spec,mesh,want", [
    ((10, 7), (("pod", "data"), "model"), ((2, 16, 16), ("pod", "data", "model")), (1, 1)),
    ((100, 30), ("data", None), ((4, 2), ("data", "model")), (25, 30)),
    ((101, 30), ("data", "model"), ((4, 2), ("data", "model")), (26, 15)),
    ((1500, 64), (None, "model"), ((16, 16), ("data", "model")), (1500, 4)),
    ((33, 7, 5), (("data", "model"),), ((4, 2), ("data", "model")), (5, 7, 5)),
    ((3, 128256), (None, ("pod", "data", "model")), ((2, 16, 16), ("pod", "data", "model")),
     (3, 251)),
    ((), (), ((4, 2), ("data", "model")), ()),
    ((9,), (None,), ((8, 1), ("data", "model")), (9,)),
])
def test_shard_shape_rounds_up(shape, spec, mesh, want):
    m = make_mesh(*mesh)
    assert sh.shard_shape(shape, PartitionSpec(*spec), m) == want
    t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    n = 1
    for d in want:
        n *= d
    assert sh.shard_bytes(t, PartitionSpec(*spec), m) == 2 * n


def test_shard_shape_refuses_a_spec_longer_than_the_shape():
    with pytest.raises(ValueError):
        sh.shard_shape((4,), PartitionSpec("data", None), make_mesh((4, 2), ("data", "model")))
