"""The port's language-model training step against the JAX package's, on
the CPU.

For each of the ten configs' ``.smoke()`` (the reference's
``tests/test_models_smoke.py::test_loss_and_grad_step``, mirrored): the
reference's ``init(PRNGKey(0))`` parameters carried across by
``convert.lm_from_reference``, the same train batch from both packages'
``make_batch``; the port's loss and every gradient leaf
(``train_loop.loss_and_grads``, ``torch.autograd.grad``) against
``jax.value_and_grad(model.loss)``; one AdamW step fed the reference's
gradients against the reference's ``opt.update``; ``remat`` "full" and
"dots" giving the bits of "none"; ``compress_tree`` fed the reference's
gradients giving its compressed gradients and residuals bitwise.

Tolerances: the loss to rtol 1e-5; every gradient leaf within 1e-4 of that
leaf's largest |g| (the packages sum in other orders: matmul against
einsum, the RG-LRU's doubling scan against ``associative_scan``, the
MoE's gather against its scatter-add; seen up to a few 1e-6 here); the
AdamW step to atol 1e-6 (a first step moves each parameter by about lr =
1e-3 times m / (sqrt(v) + eps), where XLA may fuse the update's
arithmetic differently).

``make_train_step`` is held against the reference's jitted step with
``grad_accum`` 2 and with the int8 compression on: the loss to rtol 1e-5,
the grad norm (of the gradients the update uses) to rtol 1e-4, the
gradients' own tolerance, and parameters to atol 1e-6 at all but a
thousandth of the elements, where one may move by up to 2 lr (the
residuals follow the gradients' differences; their values are held
bitwise from the same gradients by the compress_tree test). Why: the two
packages' gradients differ in their last bits (and under ``jit`` XLA
turns the quantiser's division into a multiply, ROADMAP C-ref-3), so a
gradient can land on the other side of a quantisation
level; a level that changes between 0 and +-1 flips the first Adam step's
direction at that element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import registry as r_reg
from repro.parallel import gradient_compression as r_gc
from repro.train import optimizer as r_opt
from repro.train import train_loop as r_tl
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.models import registry as t_reg
from repro_torch.parallel import gradient_compression as t_gc
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_tl

ARCHS = r_base.list_configs()
T_TRAIN = 16
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4  # of each leaf's largest |g|
STEP_ATOL = 1e-6


def _flat(tree) -> dict:
    """Reference tree (jax or numpy leaves) -> {dotted path: numpy}."""
    return {k: v.numpy() for k, v in
            convert.lm_from_reference(jax.tree.map(np.asarray, tree), "cpu").items()}


@pytest.fixture(scope="module")
def ref_runs():
    """Per arch, once: the reference's parameters, train batch, loss and
    gradients."""
    runs = {}

    def get(arch):
        if arch not in runs:
            cfg = r_base.get_config(arch).smoke()
            model = r_reg.build_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            batch = r_reg.make_batch(cfg, batch=2, seq=T_TRAIN, kind="train", seed=1)
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
            runs[arch] = {"params": params, "batch": batch, "loss": float(loss),
                          "grads": grads, "tree": jax.tree.map(np.asarray, params)}
        return runs[arch]

    return get


def _port(arch, **kw):
    cfg = t_base.get_config(arch).smoke().replace(use_kernels=False, **kw)
    return cfg, t_reg.build_model(cfg)


def _batch(cfg, batch=2, seed=1):
    return t_reg.make_batch(cfg, batch=batch, seq=T_TRAIN, kind="train", seed=seed,
                            device="cpu")


def _assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        atol = GRAD_REL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, ref_runs):
    ref = ref_runs(arch)
    cfg, model = _port(arch)
    params = convert.lm_from_reference(ref["tree"], "cpu")
    loss, grads = t_tl.loss_and_grads(model.loss, params, _batch(cfg))
    assert loss.shape == () and not loss.requires_grad
    assert float(loss) < np.log(cfg.vocab) + 2.0
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    assert all(not g.requires_grad and g.grad_fn is None for g in grads.values())
    _assert_grads_close(grads, _flat(ref["grads"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch, ref_runs):
    ref = ref_runs(arch)
    ocfg = dict(lr=1e-3)
    want_p, want_s, want_m = r_opt.update(
        r_opt.AdamWConfig(**ocfg), ref["grads"], r_opt.init_state(ref["params"]),
        ref["params"])
    params = convert.lm_from_reference(ref["tree"], "cpu")
    grads = convert.lm_from_reference(jax.tree.map(np.asarray, ref["grads"]), "cpu")
    got_p, got_s, got_m = t_opt.update(t_opt.AdamWConfig(**ocfg), grads,
                                       t_opt.init_state(params), params)
    assert got_s["step"] == int(want_s["step"]) == 1
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=1e-6)
    assert got_m["lr"] == float(want_m["lr"])
    for name, got, want in (("params", got_p, want_p), ("m", got_s["m"], want_s["m"]),
                            ("v", got_s["v"], want_s["v"])):
        want = _flat(want)
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=STEP_ATOL,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_bits(arch, ref_runs):
    params = convert.lm_from_reference(ref_runs(arch)["tree"], "cpu")
    outs = {}
    for mode in ("none", "full", "dots"):
        cfg, model = _port(arch, remat=mode)
        outs[mode] = t_tl.loss_and_grads(model.loss, params, _batch(cfg))
    for mode in ("full", "dots"):
        assert torch.equal(outs[mode][0], outs["none"][0]), mode
        for k, g in outs["none"][1].items():
            assert torch.equal(outs[mode][1][k], g), (mode, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_compress_tree_on_reference_grads_is_bitwise(arch, ref_runs):
    """Error feedback over two steps, from the reference's gradients."""
    grads = ref_runs(arch)["grads"]
    ccfg = dict(n_bits=8, block=64)
    r_res = r_gc.init_residuals(grads)
    t_grads = convert.lm_from_reference(jax.tree.map(np.asarray, grads), "cpu")
    t_res = t_gc.init_residuals(t_grads)
    for _ in range(2):
        r_out, r_res = r_gc.compress_tree(grads, r_res, r_gc.CompressionConfig(**ccfg))
        t_out, t_res = t_gc.compress_tree(t_grads, t_res, t_gc.CompressionConfig(**ccfg))
        for name, got, want in (("grads", t_out, r_out), ("residuals", t_res, r_res)):
            want = _flat(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k],
                                              err_msg=f"{name} {k}")


@pytest.mark.parametrize("arch,accum,compress", [
    ("llama3_2_1b", 2, False),
    ("llama3_2_1b", 1, True),
    ("qwen3_moe_30b_a3b", 2, True),
    ("rwkv6_7b", 2, True),
])
def test_make_train_step_matches_reference(arch, accum, compress, ref_runs):
    ref = ref_runs(arch)
    r_cfg = r_base.get_config(arch).smoke()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    r_tcfg = r_tl.TrainConfig(optimizer=r_opt.AdamWConfig(**ocfg), grad_accum=accum,
                              compression=r_gc.CompressionConfig() if compress else None)
    r_model = r_reg.build_model(r_cfg)
    r_batch = r_reg.make_batch(r_cfg, batch=4, seq=T_TRAIN, kind="train", seed=3)
    r_state = r_tl.init_train_state(r_model, ref["params"], r_tcfg)
    want_p, want_s, want_m = jax.jit(r_tl.make_train_step(r_model, r_tcfg))(
        ref["params"], r_state, r_batch)

    cfg, model = _port(arch)
    tcfg = t_tl.TrainConfig(optimizer=t_opt.AdamWConfig(**ocfg), grad_accum=accum,
                            compression=t_gc.CompressionConfig() if compress else None)
    params = convert.lm_from_reference(ref["tree"], "cpu")
    state = t_tl.init_train_state(model, params, tcfg)
    assert ("residuals" in state) == compress
    got_p, got_s, got_m = t_tl.make_train_step(model, tcfg)(params, state,
                                                            _batch(cfg, 4, 3))
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=GRAD_REL)
    assert got_m["lr"] == float(want_m["lr"]) and got_s["opt"]["step"] == 1
    want_p = _flat(want_p)
    for k, w in want_p.items():
        g = got_p[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        diff = np.abs(g - w)
        assert diff.max() <= 2 * ocfg["lr"], k
        assert (diff > STEP_ATOL).sum() <= max(2, w.size // 1000), (k, diff.max())
    if compress:  # the values: test_compress_tree_on_reference_grads_is_bitwise
        assert sorted(got_s["residuals"]) == sorted(_flat(want_s["residuals"]))


def test_train_step_refuses_the_kernel_route():
    cfg = t_base.get_config("llama3_2_1b").smoke()
    assert cfg.use_kernels
    with pytest.raises(ValueError, match="use_kernels"):
        t_tl.make_train_step(t_reg.build_model(cfg), t_tl.TrainConfig())


def test_train_step_runs_on_the_ports_own_init():
    cfg = t_base.get_config("llama3_2_1b").smoke().replace(use_kernels=False)
    model = t_reg.build_model(cfg)
    params = model.init(0, "cpu")
    step = t_tl.make_train_step(model, t_tl.TrainConfig())
    _, _, metrics = step(params, t_tl.init_train_state(model, params,
                                                       t_tl.TrainConfig()),
                         _batch(cfg))
    assert np.isfinite(float(metrics["loss"]))


def test_prefill_and_serve_steps():
    cfg, model = _port("llama3_2_1b")
    params = model.init(0, "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=8, kind="prefill", seed=0, device="cpu")
    logits, cache = t_tl.make_prefill_step(model)(params, batch)
    want_logits, want_cache = model.prefill(params, batch)
    assert torch.equal(logits, want_logits)
    step_logits, cache = t_tl.make_serve_step(model)(params, cache, batch["tokens"][:, -1:])
    assert step_logits.shape == (2, 1, cfg.vocab) and int(cache["len"]) == 9
