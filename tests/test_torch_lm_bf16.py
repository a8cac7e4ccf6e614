"""bf16 forward parity of the language models with the JAX package, on the
CPU.

``tests/test_torch_lm.py`` holds the ``.smoke()`` configs, which are fp32,
to the reference at 1e-4. The full configs serve in bf16, and there the
two packages round at other places (PyTorch rounds every op's output to
bf16; XLA may keep a fused chain in fp32), so their bf16 logits cannot
agree to fp32's tolerance. What is held here is that the port's bf16 is no
less faithful than the reference's: each package runs a config's smoke
size twice, in fp32 and with ``dtype=bfloat16``, from the reference's own
``init(PRNGKey(0))`` parameters of each (carried across by
``convert.lm_from_reference``, bitwise for bf16 leaves), on the same
batch, and each package's bf16 prefill logits are measured against its own
fp32 ones, as ``max |bf16 - fp32| / max |fp32|``. The port's gap, on both
routes (``use_kernels``: the kernels' plain versions on the CPU), must be
at most ``FACTOR`` = 2 times the reference's, the factor the card's route
gate allows the kernel route over the portable one.

All ten configs at a 12-token prompt, and RWKV-6 (whose full-width bf16
logits sit 0.36-0.39 of the largest logit from fp32 on the card) also at
512 and 2048 tokens. With ``-s`` each case prints the three gaps (the
numbers ROADMAP's C-ref-17 records): the reference's 0.57-2.7e-2, the
port's 0.62-1.68 times them (RWKV-6: 1.03 at 12 tokens, 1.68 at 512, 0.62
at 2048), so the two packages drift alike with the prompt's length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import registry as r_reg
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.models import registry as t_reg

FACTOR = 2.0
CASES = ([(arch, 12) for arch in r_base.list_configs()]
         + [("rwkv6_7b", 512), ("rwkv6_7b", 2048)])


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _reference(arch: str, seq: int) -> dict:
    """Per dtype: the reference's parameters (numpy) and prefill logits."""
    out = {}
    cfg = r_base.get_config(arch).smoke()
    for name, c in (("float32", cfg), ("bfloat16", cfg.replace(dtype=jnp.bfloat16))):
        model = r_reg.build_model(c)
        params = model.init(jax.random.PRNGKey(0))
        batch = r_reg.make_batch(c, batch=2, seq=seq, kind="prefill", seed=7)
        logits, _ = jax.jit(model.prefill)(params, batch)
        out[name] = (jax.tree.map(np.asarray, params),
                     np.asarray(logits.astype(jnp.float32)))
    return out


def _port_logits(arch: str, seq: int, dtype, tree, use_kernels: bool) -> np.ndarray:
    cfg = t_base.get_config(arch).smoke().replace(dtype=dtype, use_kernels=use_kernels)
    model = t_reg.build_model(cfg)
    params = convert.lm_from_reference(tree, "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=seq, kind="prefill", seed=7, device="cpu")
    logits, _ = model.prefill(params, batch)
    return logits.float().numpy()


@pytest.mark.parametrize("arch,seq", CASES)
def test_bf16_gap_to_fp32_within_twice_the_reference(arch, seq):
    ref = _reference(arch, seq)
    ref_gap = _gap(ref["bfloat16"][1], ref["float32"][1])
    assert 0.0 < ref_gap < 0.1, ref_gap
    gaps = {}
    for use_kernels in (True, False):
        fp32 = _port_logits(arch, seq, torch.float32, ref["float32"][0], use_kernels)
        bf16 = _port_logits(arch, seq, torch.bfloat16, ref["bfloat16"][0], use_kernels)
        assert np.isfinite(bf16).all()
        gaps[use_kernels] = gap = _gap(bf16, fp32)
        assert gap <= FACTOR * ref_gap, (
            f"{arch} at {seq} tokens, use_kernels={use_kernels}: the port's bf16 "
            f"logits are {gap:.3e} of the largest from its fp32 ones, the "
            f"reference's {ref_gap:.3e}")
    print(f"\n{arch} at {seq} tokens: bf16 gap to fp32, reference {ref_gap:.3e}, port "
          f"{gaps[True]:.3e} (kernels) / {gaps[False]:.3e} (portable), "
          f"{max(gaps.values()) / ref_gap:.2f}x")
