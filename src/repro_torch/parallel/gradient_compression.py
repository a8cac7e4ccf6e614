"""Error-bounded gradient compression with error feedback, and the int8
gradient exchange of the data-parallel trainer.

Counterpart of the JAX package's ``parallel/gradient_compression.py``.
The quantiser is the per-block symmetric quantise -> dequantise of
:mod:`repro_torch.kernels.block_quant`: the hand-written kernel on a CUDA
tensor, its plain version (:func:`repro_torch.kernels.ref.block_quant_ref`)
on a CPU tensor. A tensor is flattened, zero-padded to a multiple of
``block`` and viewed as ``(n_blocks, block)``, as the reference does.

* :func:`compress_tree` — error feedback over a flat dict of gradients:
  ``g_hat = Q(g + r)``, ``r' = (g + r) - g_hat``.
* :func:`quantized_psum` — the exchange: every shard quantises its local
  tensor (one kernel launch), only the int8 payload and the fp32 block
  scales cross devices, and every device dequantises and sums the ``P``
  payloads in shard order, so every replica gets the same bits.

The int8 payload is ``q = round(values / scales)`` of the kernel's output.
It is exact for ``n_bits <= 8``: ``values = fl(q * s)`` with ``|q| <= 128``,
so ``q * s`` gives ``values`` back bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    n_bits: int = 8
    block: int = 64
    enabled: bool = True


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened to fp32, zero-padded to a multiple of ``block``, viewed
    as (n_blocks, block)."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.view(-1, block)


def _block_quant(xb: torch.Tensor, n_bits: int, block: int):
    """(dequantised blocks, fp32 scales (n_blocks,)): one kernel launch on a
    CUDA tensor, the plain version on a CPU tensor."""
    values, scales = ops.block_quant_op(xb, n_bits=n_bits, block=block,
                                        device=xb.device)
    return values, scales.reshape(-1)  # (n_blocks, K / block = 1)


def _quant_dequant(x: torch.Tensor, n_bits: int, block: int) -> torch.Tensor:
    """Per-block symmetric quantise -> dequantise of a tensor of any shape."""
    out, _ = _block_quant(_blocks(x, block), n_bits, block)
    return out.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


def init_residuals(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_tree(grads: dict, residuals: dict, cfg: CompressionConfig):
    """Returns ``(compressed_grads, new_residuals)``. Error feedback:
    ``g_hat = Q(g + r)``, ``r' = (g + r) - g_hat``."""
    if not cfg.enabled:
        return grads, residuals
    out, res = {}, {}
    for k, g in grads.items():
        total = g.float() + residuals[k]
        g_hat = _quant_dequant(total, cfg.n_bits, cfg.block)
        out[k] = g_hat.to(g.dtype)
        res[k] = total - g_hat.float()
    return out, res


def quantize_payload(local: torch.Tensor, n_bits: int = 8, block: int = 64):
    """The wire form of one shard: ``(q int8 (n_blocks, block), scales fp32
    (n_blocks,))`` from one quantiser launch on ``local``'s device."""
    if not 2 <= n_bits <= 8:
        raise ValueError(f"n_bits={n_bits}: the int8 payload needs 2..8 bits")
    values, scales = _block_quant(_blocks(local, block), n_bits, block)
    q = torch.round(values / scales[:, None]).to(torch.int8)
    return q, scales


def quantized_psum(shards: Sequence[torch.Tensor], n_bits: int = 8,
                   block: int = 64) -> list[torch.Tensor]:
    """Quantised sum of per-shard tensors of one shape; returns the full sum
    on every shard's device, in shard order.

    Each shard is quantised on its own device; only the int8 payloads and
    fp32 scales are copied to the other devices, and each device sums the
    dequantised payloads ``q_0 s_0 + q_1 s_1 + ...`` in shard order — the
    same operations on every device, so every device gets the same bits.
    """
    payloads = [quantize_payload(s, n_bits, block) for s in shards]
    like = shards[0]
    out = []
    for s in shards:
        dev = s.device
        total = None
        for q, sc in payloads:
            part = q.to(dev).float() * sc.to(dev)[:, None]
            total = part if total is None else total.add_(part)
        out.append(total.reshape(-1)[: like.numel()].reshape(like.shape)
                   .to(like.dtype))
    return out


def quantized_all_reduce(x, mesh, n_bits: int = 8,
                         block: int = 64) -> list[torch.Tensor]:
    """All-reduce over the data axis with the int8 wire format: ``x``'s rows
    are split over ``mesh`` (:func:`repro_torch.parallel.shard_rows`) and
    every device returns the quantised sum of the shards. Wire volume:
    int8 plus one fp32 scale a block against fp32 for a plain
    all-reduce."""
    from repro_torch.parallel import shard_rows

    return quantized_psum(shard_rows(x, mesh), n_bits=n_bits, block=block)
