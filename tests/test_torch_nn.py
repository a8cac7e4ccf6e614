"""Networks, optimiser and trainer of the port vs the reference.

Parameters are drawn by the reference's initialiser, carried across with
``repro_torch.convert`` and the same numpy inputs go through both packages.
Tolerances: forward passes atol 1e-5 (fp32, XLA vs ATen summation order
over up to a few thousand products of O(1) values); loss and gradients
rtol 1e-4; one AdamW step atol 1e-6 on parameters of O(0.1); a five-step
trajectory on the reference's own batch indices rtol 1e-3 (step-to-step
amplification of the above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import families as r_families
from repro.core import autoencoder as r_ae
from repro.core import correction as r_corr
from repro.train import optimizer as r_opt
from repro.train import train_loop as r_loop
from repro_torch import convert
from repro_torch.codec import families as t_families
from repro_torch.core import autoencoder as t_ae
from repro_torch.core import correction as t_corr
from repro_torch.train import optimizer as t_opt

S, BLOCK, LATENT, CHANS = 4, (4, 5, 4), 6, (8, 16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ae_pair():
    ref = r_ae.BlockAutoencoder(r_ae.AEConfig(
        n_species=S, block=BLOCK, latent=LATENT, conv_channels=CHANS))
    params = ref.init(jax.random.PRNGKey(0))
    port = t_ae.BlockAutoencoder(t_ae.AEConfig(
        n_species=S, block=BLOCK, latent=LATENT, conv_channels=CHANS))
    return ref, params, port, convert.from_reference(_np_tree(params))


@pytest.fixture(scope="module")
def corr_pair():
    ref = r_corr.TensorCorrectionNetwork(r_corr.CorrectionConfig(n_species=S))
    params = ref.init(jax.random.PRNGKey(1))
    port = t_corr.TensorCorrectionNetwork(t_corr.CorrectionConfig(n_species=S))
    return ref, params, port, convert.from_reference(_np_tree(params))


def _blocks(n=24, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(n, S, *BLOCK)).astype(np.float32)


def test_convert_roundtrip_and_layouts(ae_pair):
    _, params, port, state = ae_pair
    tree = _np_tree(params)
    assert set(state) == set(port.state_dict())
    for name, p in port.state_dict().items():
        assert tuple(state[name].shape) == tuple(p.shape), name
    back = convert.to_reference(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert port.defs == jax.tree.map(lambda a: tuple(a.shape), tree)


def test_encode_matches(ae_pair):
    ref, params, port, state = ae_pair
    x = _blocks()
    want = np.asarray(ref.encode(params, jnp.asarray(x)))
    got = port.encode(torch.from_numpy(x), state).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_decode_matches(ae_pair):
    ref, params, port, state = ae_pair
    z = np.random.default_rng(1).normal(size=(24, LATENT)).astype(np.float32)
    want = np.asarray(ref.decode(params, jnp.asarray(z)))
    got = port.decode(torch.from_numpy(z), state).numpy()
    assert got.shape == want.shape == (24, S, *BLOCK)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_conv_transpose_is_plain_unflipped_conv():
    """The reference's stride-1 SAME transposed conv equals its XLA
    ``conv_transpose``; the port's single conv function reproduces it."""
    from repro.nn import layers as r_layers
    from repro_torch.nn import layers as t_layers

    layer = r_layers.conv3d_transpose(3, 5, (3, 3, 3), impl="xla")
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(3, 3, 3, 3, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    x = rng.normal(size=(2, 4, 5, 4, 3)).astype(np.float32)  # NDHWC
    want = np.asarray(layer.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    st = convert.from_reference({"c": p})
    got = t_layers.conv3d_transpose(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), st["c.weight"], st["c.bias"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               atol=1e-5, rtol=0)


def test_correction_matches(corr_pair):
    ref, params, port, state = corr_pair
    v = np.random.default_rng(3).uniform(size=(300, S)).astype(np.float32)
    want = np.asarray(ref(params, jnp.asarray(v)))
    got = port(torch.from_numpy(v), state).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pointwise_reshuffles_identical():
    b = _blocks(5)
    np.testing.assert_array_equal(t_corr.blocks_to_pointwise(b),
                                  r_corr.blocks_to_pointwise(b))
    v = r_corr.blocks_to_pointwise(b)
    np.testing.assert_array_equal(t_corr.pointwise_to_blocks(v, b), b)
    np.testing.assert_array_equal(
        t_corr.blocks_to_pointwise(torch.from_numpy(b)).numpy(), v)
    np.testing.assert_array_equal(
        t_corr.pointwise_to_blocks(torch.from_numpy(v), b).numpy(), b)


@pytest.mark.parametrize("with_corr", [True, False])
def test_fused_decode_vecs_match(ae_pair, corr_pair, with_corr):
    ref, params, port, state = ae_pair
    cref, cparams, cport, cstate = corr_pair
    z = np.random.default_rng(4).normal(size=(24, LATENT)).astype(np.float32)
    want = np.asarray(r_families.make_fused_decode(
        ref, cref if with_corr else None)(
            params, cparams if with_corr else None, jnp.asarray(z)))
    fused = t_families.make_fused_decode(port, cport if with_corr else None)
    with torch.no_grad():
        got = fused(state, cstate if with_corr else None, torch.from_numpy(z))
    assert got.shape == want.shape == (S, 24, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _torch_loss_and_grads(loss_fn, state, *batch):
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    loss = loss_fn(leaves, *[torch.from_numpy(b) for b in batch])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def test_ae_loss_and_grads_match(ae_pair):
    ref, params, port, state = ae_pair
    x = _blocks(16, seed=5)
    want_loss, want_g = jax.value_and_grad(r_ae._ae_loss(ref))(params, jnp.asarray(x))
    loss, grads = _torch_loss_and_grads(t_ae.ae_loss(port), state, x)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    want_g = convert.from_reference(_np_tree(want_g))
    for name, g in grads.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_correction_loss_and_grads_match(corr_pair):
    ref, params, port, state = corr_pair
    rng = np.random.default_rng(6)
    a = rng.uniform(size=(200, S)).astype(np.float32)
    b = rng.uniform(size=(200, S)).astype(np.float32)
    want_loss, want_g = jax.value_and_grad(r_corr._corr_loss(ref))(
        params, jnp.asarray(a), jnp.asarray(b))
    loss, grads = _torch_loss_and_grads(t_corr.corr_loss(port), state, a, b)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    want_g = convert.from_reference(_np_tree(want_g))
    for name, g in grads.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("step", [1, 20, 200])
def test_schedule_matches(step):
    for total in (0, 50, 200):
        r_cfg = r_loop.adamw_cfg(2e-3, total)
        t_cfg = t_opt.adamw_cfg(2e-3, total)
        assert (r_cfg.warmup_steps, r_cfg.total_steps) == (
            t_cfg.warmup_steps, t_cfg.total_steps)
        want = float(r_opt.schedule(r_cfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(t_opt.schedule(t_cfg, step), want,
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("step", [1, 20, 200])  # first, warm-up end, last
def test_adamw_step_matches(step):
    total = 200
    rng = np.random.default_rng(step)
    shapes = {"a": {"w": (3, 3, 3, 2, 4), "b": (4,)}, "d": {"w": (12, 5), "b": (5,)}}
    draw = lambda scale: {k: {l: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
                              for l, s in v.items()} for k, v in shapes.items()}
    params, grads, m = draw(0.1), draw(3.0), draw(0.01)
    v = jax.tree.map(lambda a: np.abs(a).astype(np.float32), draw(0.01))
    r_state = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
               "step": jnp.asarray(step - 1, jnp.int32)}
    want_p, want_s, want_metrics = r_opt.update(
        r_loop.adamw_cfg(2e-3, total), jax.tree.map(jnp.asarray, grads),
        r_state, jax.tree.map(jnp.asarray, params))
    t_state = {"m": convert.from_reference(m), "v": convert.from_reference(v),
               "step": step - 1}
    got_p, got_s, metrics = t_opt.update(
        t_opt.adamw_cfg(2e-3, total), convert.from_reference(grads), t_state,
        convert.from_reference(params))
    assert got_s["step"] == int(want_s["step"]) == step
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(want_metrics["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["lr"], float(want_metrics["lr"]), rtol=1e-6)
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        want = convert.from_reference(_np_tree(want))
        for name in got:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_ae_trajectory_matches_on_reference_indices(ae_pair):
    ref, params, port, state = ae_pair
    blocks = _blocks(40, seed=7)
    steps, bs, seed = 5, 8, 0
    want_p, want_losses = r_ae.fit_reference(
        ref, blocks, steps=steps, batch_size=bs, lr=2e-3, seed=seed)
    idx = r_loop.all_batch_indices(seed, steps, blocks.shape[0], bs)
    got_p, losses = t_ae.fit(
        port, blocks, steps=steps, batch_size=bs, lr=2e-3, seed=seed,
        params=state, indices=idx, device="cpu")
    assert losses.dtype == np.float32 and losses.shape == (steps,)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    want_p = convert.from_reference(_np_tree(want_p))
    for name in got_p:
        np.testing.assert_allclose(got_p[name].numpy(), want_p[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_correction_trajectory_matches_on_reference_indices(corr_pair):
    ref, params, port, state = corr_pair
    rng = np.random.default_rng(8)
    a = rng.uniform(size=(500, S)).astype(np.float32)
    b = (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
    steps, bs, seed = 5, 64, 1
    want_p, want_losses = r_corr.fit_reference(
        ref, a, b, steps=steps, batch_size=bs, lr=1e-3, seed=seed)
    idx = r_loop.all_batch_indices(seed, steps, a.shape[0], bs)
    got_p, losses = t_corr.fit(
        port, a, b, steps=steps, batch_size=bs, lr=1e-3, seed=seed,
        params=state, indices=idx, device="cpu")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    want_p = convert.from_reference(_np_tree(want_p))
    for name in got_p:
        np.testing.assert_allclose(got_p[name].numpy(), want_p[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_init_law_and_seed_reproducibility():
    """Own generator, the reference's laws: normal with std 1/sqrt(fan_in),
    zero bias; one seed gives one set of parameters."""
    cfg = t_ae.AEConfig(n_species=S, block=BLOCK, latent=LATENT,
                        conv_channels=(32, 64))
    a, b = t_ae.init_params(cfg, 3, "cpu"), t_ae.init_params(cfg, 3, "cpu")
    c = t_ae.init_params(cfg, 4, "cpu")
    for name in a:
        assert torch.equal(a[name], b[name])
    assert not torch.equal(a["enc_fc.weight"], c["enc_fc.weight"])
    assert float(a["dec_fc.bias"].abs().max()) == 0.0
    w = a["enc_fc.weight"]  # (out, in): fan_in is the second axis
    np.testing.assert_allclose(float(w.std()), 1 / np.sqrt(w.shape[1]), rtol=0.05)
    w = a["dec_conv0.weight"]
    np.testing.assert_allclose(float(w.std()), 1 / np.sqrt(27 * w.shape[1]),
                               rtol=0.05)


def test_trainer_is_deterministic_per_seed():
    port = t_ae.BlockAutoencoder(t_ae.AEConfig(
        n_species=S, block=BLOCK, latent=LATENT, conv_channels=CHANS))
    blocks = _blocks(40, seed=9)
    runs = [t_ae.fit(port, blocks, steps=4, batch_size=8, seed=2, device="cpu")
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    for name in runs[0][0]:
        assert torch.equal(runs[0][0][name], runs[1][0][name])
