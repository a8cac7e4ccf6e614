"""Batched serving loop: prefill, then greedy or sampled decode.

Port of the JAX package's ``serve/serve_loop.py``, eager, on an explicit
device. The model's ``prefill`` and ``decode_step`` are called as they
are (the reference jit-compiles them); the tokens stay on the device until
the loop ends.

Sampling (``greedy=False``) draws each step's token per row from
``softmax(logits[:, -1])`` in fp32 with ``torch.multinomial`` and a
``torch.Generator`` seeded with ``seed`` on the serving device: the same
seed gives the same tokens, but not ``jax.random.categorical``'s.

With ``cfg.kv_quant`` (a :class:`~repro_torch.models.transformer.DecoderLM`)
the dense prefill cache is quantised into ``decode_step``'s int8 layout
before the first step (``model.quantize_cache``); the reference's Server
has no such step and cannot decode with ``kv_quant``.

A linear KV cache (``k`` / ``k_q`` without a ring buffer) must hold the
prompt — patches included, for a VLM — and every new token: ``generate``
raises ``ValueError`` before the first step where it would not (the
reference's ``dynamic_update_slice`` clamps the write and overwrites the
last slot; a CUDA index past the end would fault).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0


class Server:
    def __init__(self, model, params, *, max_len: int = 512,
                 device: DeviceLike = None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        self.stats = ServeStats()

    def _prefill(self, batch):
        logits, cache = self.model.prefill(self.params, batch, max_len=self.max_len)
        if getattr(self.model.cfg, "kv_quant", False) and "k" in cache:
            cache = self.model.quantize_cache(cache)
        return logits, cache

    def generate(self, batch: dict[str, Any], n_new: int,
                 greedy: bool = True, seed: int = 0) -> np.ndarray:
        """Returns (B, n_new) generated token ids (int32)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        logits, cache = self._prefill(batch)
        self._check_room(cache, n_new)
        self.stats.prefill_tokens += batch["tokens"].numel()
        b = batch["tokens"].shape[0]
        gen = None if greedy else torch.Generator(device=self.device).manual_seed(seed)
        tok = self._pick(logits, gen)
        out = []
        for _ in range(n_new):
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, cache, tok)
            tok = self._pick(logits, gen)
            self.stats.decode_tokens += b
            self.stats.steps += 1
        if not out:
            return np.zeros((b, 0), np.int32)
        return torch.cat(out, dim=1).cpu().numpy()

    @staticmethod
    def _check_room(cache, n_new: int) -> None:
        kv = cache.get("k_q", cache.get("k"))
        if kv is None or "periods" in cache:  # recurrent state, ring buffer
            return
        used = int(cache["len"])
        if used + n_new > kv.shape[2]:
            raise ValueError(
                f"the KV cache holds {kv.shape[2]} positions: {used} of the "
                f"prompt and {n_new} new tokens do not fit; raise max_len")

    @staticmethod
    def _pick(logits, gen):
        if gen is None:
            return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        probs = torch.softmax(logits[:, -1].float(), dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
