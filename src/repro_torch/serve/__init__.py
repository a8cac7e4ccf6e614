"""Serving layer: concurrent query workloads over compressed fields, and
the language-model serving loop.

:mod:`repro_torch.serve.decode_service` is a continuous-batched
selective-decode server over GBATC container blobs (see its module
docstring for the scheduler design and bit-identity contract).
:mod:`repro_torch.serve.serve_loop` (:class:`Server`) runs prefill and
decode of the language models, and :mod:`repro_torch.serve.kvcache` holds
the int8 KV cache.
"""

from repro_torch.serve.decode_service import DecodeService, ServeStats
from repro_torch.serve.serve_loop import Server

__all__ = ["DecodeService", "ServeStats", "Server"]
