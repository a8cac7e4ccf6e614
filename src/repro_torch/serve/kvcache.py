"""Quantized KV cache: int8 KV storage with per-(token, head) fp32 scales.

Port of the JAX package's ``serve/kvcache.py``: the same payload and
scales, bit for bit, on the same inputs. A dataclass of tensors (the
reference registers it as a pytree; nothing here needs that). The
decode path of :class:`repro_torch.models.transformer.DecoderLM` with
``cfg.kv_quant`` keeps the same layout in its cache dict.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class QuantizedKVCache:
    """int8 KV storage with fp32 scales; drop-in for the dense cache dict."""

    k_q: torch.Tensor  # (L, B, T, H, D) int8
    v_q: torch.Tensor
    k_scale: torch.Tensor  # (L, B, T, H, 1) fp32
    v_scale: torch.Tensor
    length: torch.Tensor  # 0-d int32

    @classmethod
    def create(cls, n_layers, batch, max_len, n_kv, d_head,
               device: DeviceLike = None) -> "QuantizedKVCache":
        dev = resolve_device(device)
        shape = (n_layers, batch, max_len, n_kv, d_head)
        sshape = (n_layers, batch, max_len, n_kv, 1)
        return cls(
            k_q=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_q=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, device=dev),
            v_scale=torch.zeros(sshape, device=dev),
            length=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @staticmethod
    def _quant(x):
        scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-30) / 127.0
        q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
        return q, scale.float()

    def append(self, k_new, v_new) -> "QuantizedKVCache":
        """k_new/v_new: (L, B, 1, H, D) at position self.length; returns a
        new cache (this one is left as it was)."""
        kq, ks = self._quant(k_new.float())
        vq, vs = self._quant(v_new.float())
        pos = self.length.reshape(1).long()
        return QuantizedKVCache(
            k_q=self.k_q.index_copy(2, pos, kq),
            v_q=self.v_q.index_copy(2, pos, vq),
            k_scale=self.k_scale.index_copy(2, pos, ks),
            v_scale=self.v_scale.index_copy(2, pos, vs),
            length=self.length + 1,
        )

    def dequant_layer(self, layer: int, dtype=torch.bfloat16):
        k = (self.k_q[layer].float() * self.k_scale[layer]).to(dtype)
        v = (self.v_q[layer].float() * self.v_scale[layer]).to(dtype)
        return k, v

    def max_abs_error_bound(self):
        """Per-element |x - deq(q)| <= scale/2 — the KV analogue of the
        codec's quantization bound."""
        return self.k_scale.max() / 2.0, self.v_scale.max() / 2.0
