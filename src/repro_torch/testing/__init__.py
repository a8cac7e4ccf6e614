"""Test-support utilities shipped with the package (deterministic fault
injection for container blobs; see :mod:`repro_torch.testing.faults`)."""
