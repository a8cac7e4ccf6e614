"""repro_torch: the PyTorch/CUDA port of GBATC (guaranteed block autoencoder
with tensor correlations), beside the JAX reference package ``repro``.

Same layout as the reference, so a module's counterpart is found by path:

  repro_torch.codec    — bytes-in/bytes-out container codec (v5)
  repro_torch.core     — pipeline, guarantee engine, host primitives
  repro_torch.nn       — layers of the conv block autoencoder
  repro_torch.train    — AdamW and the mini-batch trainer
  repro_torch.kernels  — hand-written CUDA kernels, their plain PyTorch
                         versions and the device dispatch
  repro_torch.data     — synthetic S3D surrogate
  repro_torch.convert  — parameter trees <-> ``state_dict`` layouts

Every entry point takes ``device=None``, which means the GPU and raises
when CUDA is unavailable; pass ``device="cpu"`` to run the plain versions.
The package imports ``torch`` and numpy only.
"""

__version__ = "0.1.0"
