"""Layers of the conv block autoencoder and the correction network.

Only what the conv family uses: dense, conv3d, conv3d_transpose and
leaky_relu. Each layer is a small ``nn.Module`` holding its parameters in
PyTorch's layouts (``Linear``: (out, in); convolutions: (O, I, D, H, W))
plus a plain function of (input, weight, bias), so a decode runtime can
run a model on parameters that arrived in a container without touching
the module's own.

Against the reference layouts (dense ``w`` (in, out); conv kernels DHWIO
over NDHWC activations): :mod:`repro_torch.convert` carries parameters
across. At stride 1, SAME padding and an odd kernel the reference's
transposed convolution is the plain cross-correlation with the same
(unflipped) kernel, so both convolutions here are ``F.conv3d`` with
``padding = kernel // 2`` — not ``ConvTranspose3d``.

Initialisation follows the reference's laws — normal with std
``1/sqrt(fan_in)``, zero bias — drawn from an explicit ``torch.Generator``;
the numbers differ from the reference's (its generator is not PyTorch's).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` (out, in)."""
    return F.linear(x, weight, bias)


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 SAME cross-correlation; ``x`` (N, C, D, H, W), ``weight``
    (O, I, kd, kh, kw) with odd kernel sizes."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    return F.conv3d(x, weight, bias, stride=1, padding=pad)


#: the reference's stride-1 SAME transposed convolution is the same map
conv3d_transpose = conv3d


def normal_fan_in(shape, fan_in: int, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """Normal draws with std ``1/sqrt(fan_in)``, the reference's init law;
    drawn on the CPU so one seed gives one set of numbers on any device."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w / math.sqrt(fan_in)).to(device)


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            normal_fan_in((out_dim, in_dim), in_dim, generator, device))
        self.bias = nn.Parameter(
            torch.zeros(out_dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return dense(x, self.weight, self.bias)


class Conv3d(nn.Module):
    """3x3x3-style stride-1 SAME convolution (also the reference's
    stride-1 transposed convolution, see module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if any(k % 2 == 0 for k in kernel):
            raise ValueError(f"SAME conv needs an odd kernel, got {kernel}")
        fan_in = in_ch * math.prod(kernel)
        self.weight = nn.Parameter(
            normal_fan_in((out_ch, in_ch, *kernel), fan_in, generator, device))
        self.bias = nn.Parameter(
            torch.zeros(out_ch, dtype=torch.float32, device=device))

    def forward(self, x):
        return conv3d(x, self.weight, self.bias)


Conv3dTranspose = Conv3d
