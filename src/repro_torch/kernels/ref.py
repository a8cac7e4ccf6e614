"""Plain PyTorch versions of the CUDA kernels in ``csrc/gbatc_kernels.cu``.

Each is the oracle its kernel is held against on the card, and what
:mod:`repro_torch.kernels.ops` runs for tensors that live on the CPU.
Nothing on the main path calls them when the device is CUDA.
"""

from __future__ import annotations

import torch


def gbatc_project_batched_ref(residual: torch.Tensor,
                              basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``C_s = R_s @ U_s``; (S, NB, D) x (S, D, D) -> (S, NB, D)."""
    return torch.matmul(residual, basis)


def gbatc_correct_batched_ref(x_rec: torch.Tensor, coeffs: torch.Tensor,
                              basis: torch.Tensor) -> torch.Tensor:
    """Per-species ``x_s + C_s @ U_s^T`` (coefficients already masked)."""
    return x_rec + torch.matmul(coeffs, basis.transpose(1, 2))


def gbatc_select_accumulate_ref(x_rec: torch.Tensor, coeff_vals: torch.Tensor,
                                rank: torch.Tensor, m: torch.Tensor,
                                basis: torch.Tensor) -> torch.Tensor:
    """``x + (c . [rank < m[..., None]]) @ U_s^T`` with the mask as a
    ``where`` (never a stored 0/1 tensor on the kernel side)."""
    kept = torch.where(rank < m[..., None], coeff_vals,
                       torch.zeros((), dtype=coeff_vals.dtype,
                                   device=coeff_vals.device))
    return x_rec + torch.matmul(kept, basis.transpose(1, 2))
