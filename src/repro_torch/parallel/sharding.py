"""Sharding rules: logical axes -> mesh axes (the DP / TP / EP / ZeRO map),
and the bytes each device holds under them.

The counterpart of the JAX package's ``parallel/sharding.py``, function for
function, under the same names and semantics:

* DP: batch over ("pod", "data"), or over the axes that divide it;
* TP: heads / d_ff / vocab / experts over "model" (Megatron-style);
* EP: the MoE expert axis over "model";
* ZeRO-1: optimizer moments also sharded over the DP axes, on the first
  replicated dim they divide;
* KV caches: heads over "model" when they divide, else the cache length.

A mesh is anything with ``.shape`` (axis name -> size) and ``.axis_names``:
a :class:`repro_torch.launch.mesh.LogicalMesh` here, and the functions also
take a ``jax.sharding.AbstractMesh``. The port has one controller over a
device list and no partitioner, so these rules place nothing: they are
accounting. :func:`shard_shape` and :func:`shard_bytes` give each device's
share of a leaf, ``ceil(dim / product of the dim's mesh axes)`` a dim,
which is the law XLA pads a non-divisible sharding by. The reference's
``param_shardings`` and ``batch_shardings`` return ``NamedSharding``\\ s,
which have no counterpart without a partitioner, and are left out.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.nn.module import PartitionSpec as P


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_axes_for(mesh, batch: int) -> tuple[str, ...]:
    """DP axes whose product divides ``batch`` (else replicate: e.g. the
    single-stream long_500k cell with global batch 1)."""
    axes = dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    if batch % max(n, 1) == 0:
        return axes
    if "data" in axes and batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def tp_size(mesh) -> int:
    return mesh.shape["model"]


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def make_rules(cfg: ArchConfig, mesh) -> dict[str, Any]:
    """The logical-axis table every model's ``pspecs`` maps through; the
    reference's, entry for entry ("mlp" and "vocab" go to "model" whether
    or not they divide, and are padded)."""
    tp = tp_size(mesh)
    return {
        "embed": None,  # activations' d_model stays replicated on the weight side
        "embed_shard": "model" if cfg.d_model % tp == 0 else None,
        "heads": "model" if (cfg.n_heads * cfg.head_dim) % tp == 0 else None,
        "kv_heads": "model" if (cfg.n_kv_heads * cfg.head_dim) % tp == 0 else None,
        "mlp": "model",
        "expert": "model" if (cfg.n_experts and cfg.n_experts % tp == 0) else None,
        "vocab": "model",
        "layers": None,
    }


def param_pspecs(model, cfg: ArchConfig, mesh) -> dict[str, P]:
    return model.pspecs(make_rules(cfg, mesh))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict[str, P]:
    dp = dp_axes_for(mesh, shape.global_batch)
    specs = {"tokens": P(dp, None)}
    if shape.kind == "train":
        specs["labels"] = P(dp, None)
    if cfg.is_encdec and shape.kind != "decode":
        specs["frames"] = P(dp, None, None)
    if cfg.is_vlm and shape.kind != "decode":
        specs["patches"] = P(dp, None, None)
    return specs


# ---------------------------------------------------------------------------
# optimizer state (ZeRO-1)
# ---------------------------------------------------------------------------
def zero_pspec(spec: torch.Tensor, pspec: P, mesh) -> P:
    """Shard the first replicated dim of a moment tensor (``spec``: a meta
    tensor) that the DP size divides over the DP axes (ZeRO-1). Scalars
    and leaves already sharded over a DP axis pass through."""
    dims = list(pspec) + [None] * (len(spec.shape) - len(pspec))
    dp = dp_axes(mesh)
    dp_n = dp_size(mesh)
    used = {a for d in dims if d is not None
            for a in (d if isinstance(d, tuple) else (d,))}
    if any(a in used for a in dp):
        return pspec
    for i, (dim, assignment) in enumerate(zip(spec.shape, dims)):
        if assignment is None and dim % dp_n == 0 and dim > 0:
            dims[i] = dp if len(dp) > 1 else dp[0]
            return P(*dims)
    return pspec


def optimizer_pspecs(model, cfg: ArchConfig, mesh, zero: bool = True) -> dict:
    """Pspecs mirroring the optimizer state: ``{m, v, step}``."""
    pspecs = param_pspecs(model, cfg, mesh)
    if zero:
        specs = model.specs()
        moments = {k: zero_pspec(specs[k], ps, mesh) for k, ps in pspecs.items()}
    else:
        moments = pspecs
    return {"m": moments, "v": dict(moments), "step": P()}


# ---------------------------------------------------------------------------
# KV / recurrent-state caches
# ---------------------------------------------------------------------------
def cache_pspecs(model, cfg: ArchConfig, mesh, batch: int = 0) -> dict:
    """Pspecs mirroring ``model.cache_specs(batch, max_len)``."""
    dp = dp_axes_for(mesh, batch) if batch else dp_axes(mesh)
    tp = tp_size(mesh)

    def kv_spec():
        # (L, B, T, Hkv, D): heads if they divide, else the cache length
        if cfg.n_kv_heads % tp == 0 or cfg.kv_shard_heads_padded:
            return P(None, dp, None, "model", None)
        return P(None, dp, "model", None, None)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        if cfg.kv_quant:
            out = {"k_q": kv_spec(), "v_q": kv_spec(),
                   "k_s": kv_spec(), "v_s": kv_spec(), "len": P()}
        else:
            out = {"k": kv_spec(), "v": kv_spec(), "len": P()}
        if cfg.mrope_sections:
            out["pos_next"] = P()
        return out
    if fam == "audio":
        # the cross-attention KV's n_audio_ctx (1500) divides nothing: replicated
        cross = P(None, dp, None, None, None)
        return {"k": kv_spec(), "v": kv_spec(), "ck": cross, "cv": cross, "len": P()}
    if fam == "ssm":
        d_ok = "model" if cfg.d_model % tp == 0 else None
        return {
            "tm_x": P(None, dp, d_ok),
            "cm_x": P(None, dp, d_ok),
            "s": P(None, dp, "model", None, None),  # (L, B, H, N, N): heads
            "len": P(),
        }
    if fam == "hybrid":
        w_ok = "model" if (cfg.rglru_width or cfg.d_model) % tp == 0 else None
        rec = {"h": P(None, dp, w_ok), "conv": P(None, dp, None, w_ok)}
        tail_rec = {"h": P(dp, w_ok), "conv": P(dp, None, w_ok)}
        n_tail = cfg.n_layers - 3 * (cfg.n_layers // 3)
        return {
            "periods": {"r1": rec, "r2": dict(rec)},
            "tail": {f"t{i}": dict(tail_rec) for i in range(n_tail)},
            # one KV head (MQA): the window length over "model"
            "k": P(None, dp, "model", None, None),
            "v": P(None, dp, "model", None, None),
            "len": P(),
        }
    raise KeyError(fam)


def logits_pspec(cfg: ArchConfig, mesh) -> P:
    return P(dp_axes(mesh), None, "model" if cfg.vocab % tp_size(mesh) == 0 else None)


# ---------------------------------------------------------------------------
# per-device accounting
# ---------------------------------------------------------------------------
def shard_shape(shape, pspec: P, mesh) -> tuple[int, ...]:
    """One device's block of an array of ``shape`` placed by ``pspec``:
    each dim divided by the product of its mesh axes' sizes, rounded up
    (the padded shard of a non-divisible dim)."""
    shape = tuple(int(n) for n in shape)
    if len(pspec) > len(shape):
        raise ValueError(f"pspec {pspec} has more entries than shape {shape} has dims")
    out = []
    for i, n in enumerate(shape):
        entry = pspec[i] if i < len(pspec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        out.append(-(-n // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


def shard_bytes(spec: torch.Tensor, pspec: P, mesh) -> int:
    """Bytes of one device's shard of ``spec`` (a tensor, meta or real)."""
    return math.prod(shard_shape(spec.shape, pspec, mesh)) * spec.element_size()
