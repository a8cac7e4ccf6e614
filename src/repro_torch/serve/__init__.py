"""Serving layer: concurrent query workloads over compressed fields.

:mod:`repro_torch.serve.decode_service` is a continuous-batched
selective-decode server over GBATC container blobs (see its module
docstring for the scheduler design and bit-identity contract).
"""

from repro_torch.serve.decode_service import DecodeService, ServeStats

__all__ = ["DecodeService", "ServeStats"]
