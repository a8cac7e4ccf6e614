"""RWKV-6 with 128-wide heads (past ``rwkv6_scan``'s old N = 64), the port
against the JAX package on the CPU.

RWKV-6's ``.smoke()`` widened to 128-wide heads (d_model 256) on the
reference's parameters (``convert.lm_from_reference``): prefill logits
and cache under both ``use_kernels`` and the loss at the tolerances of
``test_torch_lm.py`` and ``test_torch_lm_train.py``, one AdamW step fed
the reference's gradients at ``test_torch_lm_train.py``'s, and every
gradient within 2e-4 of the leaf's largest |g|: at N = 128 each
package's fp32 rounding alone reaches about 1e-4 of it (against the
port's graph run wholly in fp64, seen: the port 6.4e-5, the reference
1.0e-4, both largest on ``tm.wr`` / ``tm.bonus``, whose sums run over
128-long rows), so their gap is up to the sum of the two; the smoke
size's N = 16 keeps ``test_torch_lm_train.py``'s 1e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_lm import _assert_tree_close

from repro.configs import base as r_base
from repro.models import registry as r_reg
from repro.train import optimizer as r_opt
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.models import registry as t_reg
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_tl

WIDEN = dict(d_model=256, rwkv_head_dim=128)
T_PROMPT, T_TRAIN, TOL = 12, 16, dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is many small ops. On one thread they run
    without waiting for the threads of the other pytest workers that share
    the cores (at eight threads under six workers the wide-head codec's fit
    took 19 times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rwkv_ref():
    cfg = r_base.get_config("rwkv6_7b").smoke().replace(**WIDEN)
    model = r_reg.build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))  # both packages take these
    batch = r_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7)
    logits, cache = jax.jit(model.prefill)(params, batch)
    train = r_reg.make_batch(cfg, batch=2, seq=T_TRAIN, kind="train", seed=1)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, train)
    return {"params": params, "tree": jax.tree.map(np.asarray, params),
            "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache),
            "loss": float(loss), "grads": grads}


def _flat(tree) -> dict:
    return {k: v.numpy() for k, v in
            convert.lm_from_reference(jax.tree.map(np.asarray, tree), "cpu").items()}


def _rwkv_port(**kw):
    cfg = t_base.get_config("rwkv6_7b").smoke().replace(**WIDEN, **kw)
    assert cfg.d_model // cfg.rwkv_head_dim == 2
    return cfg, t_reg.build_model(cfg)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "portable"])
def test_rwkv6_head_128_prefill_matches_reference(rwkv_ref, use_kernels):
    cfg, model = _rwkv_port(use_kernels=use_kernels)
    params = convert.lm_from_reference(rwkv_ref["tree"], "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7,
                             device="cpu")
    logits, cache = model.prefill(params, batch)
    _assert_tree_close(logits, rwkv_ref["logits"], "logits", **TOL)
    _assert_tree_close(cache, rwkv_ref["cache"], "cache", **TOL)


def test_rwkv6_head_128_grads_and_adamw_step_match_reference(rwkv_ref):
    cfg, model = _rwkv_port(use_kernels=False)
    params = convert.lm_from_reference(rwkv_ref["tree"], "cpu")
    train = t_reg.make_batch(cfg, batch=2, seq=T_TRAIN, kind="train", seed=1,
                             device="cpu")
    loss, grads = t_tl.loss_and_grads(model.loss, params, train)
    np.testing.assert_allclose(float(loss), rwkv_ref["loss"], rtol=1e-5)
    want_g = _flat(rwkv_ref["grads"])
    assert sorted(grads) == sorted(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=2e-4 * float(np.abs(w).max()), err_msg=k)
    ocfg = dict(lr=1e-3)
    want_p, _, _ = jax.jit(functools.partial(r_opt.update, r_opt.AdamWConfig(**ocfg)))(
        rwkv_ref["grads"], r_opt.init_state(rwkv_ref["params"]), rwkv_ref["params"])
    ref_grads = convert.lm_from_reference(jax.tree.map(np.asarray, rwkv_ref["grads"]), "cpu")
    got_p, _, _ = t_opt.update(t_opt.AdamWConfig(**ocfg), ref_grads,
                               t_opt.init_state(params), params)
    want_p = _flat(want_p)
    assert sorted(got_p) == sorted(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), w, rtol=0, atol=1e-6, err_msg=k)
