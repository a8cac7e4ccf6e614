"""Every CUDA kernel wrapper refuses operands that need a gradient.

No kernel has a backward: a wrapper returns outputs filled by a launch,
with no ``grad_fn``, so a gradient through it would be dropped on the card
while the CPU route (the plain versions) gives one. Each wrapper therefore
raises first, before its device check: with a CPU operand that requires a
gradient the call raises ``RuntimeError`` here, and under
``torch.no_grad()`` the same call gets as far as the device check and
raises its usual ``ValueError`` for a CPU tensor, which shows the order.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import block_quant as bq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gbatc_project as gp
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw


def _t(*shape, grad=True, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(*shape, generator=g, dtype=dtype).requires_grad_(grad)


# (wrapper name, call with one operand that requires a gradient)
CALLS = {
    "flash_attention": lambda: fa.flash_attention(
        _t(1, 2, 8, 16), _t(1, 2, 8, 16, grad=False), _t(1, 2, 8, 16, grad=False)),
    "rwkv6_scan": lambda: rw.rwkv6_scan(
        *(_t(1, 4, 2, 8, grad=False) for _ in range(3)), _t(1, 4, 2, 8),
        _t(2, 8, grad=False)),
    "rglru_scan": lambda: rg.rglru_scan(_t(1, 4, 8, grad=False), _t(1, 4, 8),
                                        _t(1, 8, grad=False)),
    "block_quant": lambda: bq.block_quant(_t(4, 64), n_bits=8, block=64),
    "gbatc_project_batched": lambda: gp.gbatc_project_batched(
        _t(2, 8, 16, grad=False), _t(2, 16, 16)),
    "gbatc_correct_batched": lambda: gp.gbatc_correct_batched(
        _t(2, 8, 16, grad=False), _t(2, 8, 16), _t(2, 16, 16, grad=False)),
    "gbatc_select_accumulate": lambda: gp.gbatc_select_accumulate(
        _t(2, 8, 16), _t(2, 8, 16, grad=False),
        torch.zeros(2, 8, 16, dtype=torch.int32), torch.zeros(2, 8, dtype=torch.int32),
        _t(2, 16, 16, grad=False)),
    "gbatc_project": lambda: gp.gbatc_project(_t(8, 16), _t(16, 16, grad=False)),
    "gbatc_correct": lambda: gp.gbatc_correct(
        _t(8, 16, grad=False), _t(8, 16), torch.ones(8, 16, dtype=torch.bool),
        _t(16, 16, grad=False)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_wrapper_refuses_gradients_before_its_device_check(name):
    with pytest.raises(RuntimeError, match=f"the {name} kernel has no backward"):
        CALLS[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors only"):
        CALLS[name]()


def test_every_public_wrapper_is_held():
    """The cases above cover each kernel wrapper that counts launches."""
    counted = set()
    for mod in (fa, rw, rg, bq, gp):
        counted |= set(mod.LAUNCHES)
    assert counted == set(CALLS)
