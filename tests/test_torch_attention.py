"""The attention encoder family of the port vs the reference.

* ``models.common``: positions, ``repeat_kv`` and the direct attention
  against the reference's from the same numpy inputs, atol 1e-6 (fp32, the
  same formula, another summation order over at most 64 products);
* ``BlockAttentionAE`` at S=4, block 4x5x4, arch (16, 2, 1, 32) on
  parameters carried across by ``convert.from_reference``: encode, decode,
  loss and gradients to 1e-5 for both ``attn_impl`` values (the
  reference's flash kernel runs in interpret mode and has no gradient, so
  the flash gradients are held against the reference's direct ones), and a
  five-step fit on the reference's batch indices to rtol 1e-4;
* ``convert``: the attention tree round-trips exactly and the packed
  decoder stream is byte-identical to the reference's ``pack_params``;
* the codec end to end on the CPU at the reference's family-test sizes
  (S=4, 16x20x16, 40 AE steps, bound 1e-2): each package decodes the
  other's attention blob within ``bound * (1 + 1e-3)``, the slack the
  reference allows for a decoder run on another backend;
* wire strictness and runtime isolation, as the reference's family suite
  checks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gae import reference_pallas_load, reference_x64  # noqa: F401  (module-scoped shim fixtures)

from repro import codec as r_codec
from repro.codec import families as r_families
from repro.codec import params as r_params
from repro.core.pipeline import PipelineConfig as RefConfig
from repro.data import s3d
from repro.models import block_attention as r_ba
from repro.models import common as r_common
from repro.train import train_loop as r_loop
from repro_torch import codec as t_codec
from repro_torch import convert
from repro_torch.codec import families as t_families
from repro_torch.codec import format as t_wire
from repro_torch.codec import params as t_params
from repro_torch.codec import runtime as t_runtime
from repro_torch.core import container as t_container
from repro_torch.core import correction as t_corr
from repro_torch.core import metrics
from repro_torch.core.container import ContainerFormatError, ContainerReader
from repro_torch.core.pipeline import GBATCCodec, PipelineConfig
from repro_torch.models import block_attention as t_ba
from repro_torch.models import common as t_common

S, BLOCK, LATENT, ARCH = 4, (4, 5, 4), 8, (16, 2, 1, 32)
BOUND = 1e-2
CFG = dict(n_species=S, block=BLOCK, latent=LATENT, d_model=ARCH[0],
           n_heads=ARCH[1], depth=ARCH[2], mlp_hidden=ARCH[3])
PIPE_KW = dict(family="attention", arch=ARCH, ae_steps=40, corr_steps=4, seed=0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _blocks(n=12, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(n, S, *BLOCK)).astype(np.float32)


# -- models.common ----------------------------------------------------------
def test_sinusoidal_positions_identical():
    for n, d in ((16, 16), (232, 32), (7, 6)):
        np.testing.assert_array_equal(t_common.sinusoidal_positions(n, d),
                                      r_common.sinusoidal_positions(n, d))


@pytest.mark.parametrize("causal,window,q_offset,hkv", [
    (False, 0, 0, 4), (True, 0, 0, 4), (True, 5, 0, 2), (True, 0, 3, 1),
    (False, 7, 0, 2)])
def test_direct_attention_matches(causal, window, q_offset, hkv):
    rng = np.random.default_rng(hkv + window + q_offset)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 30, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 30, hkv, 16)).astype(np.float32)
    want = r_common.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=q_offset)
    got = t_common.attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window,
                             q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        t_common.repeat_kv(torch.from_numpy(k), 4 // hkv).numpy(),
        np.asarray(r_common.repeat_kv(jnp.asarray(k), 4 // hkv)))


def test_chunked_branch_is_not_ported():
    """Past the direct branch's limit (tq > 4096) the port takes the
    reference's chunked online-softmax branch, as the reference does, and
    matches it (tests/test_torch_lm.py holds that branch at small chunks
    too). The name is older than the port of that branch: the test once
    asserted that the port refused such lengths."""
    rng = np.random.default_rng(4097)
    q, k, v = (rng.normal(size=(1, 4097, 1, 8)).astype(np.float32) for _ in range(3))
    want = r_common.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = t_common.attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# -- BlockAttentionAE -------------------------------------------------------
@pytest.fixture(scope="module")
def ae_pair():
    ref = r_ba.BlockAttentionAE(r_ba.BlockAttentionConfig(**CFG))
    params = ref.init(jax.random.PRNGKey(0))
    port = t_ba.BlockAttentionAE(t_ba.BlockAttentionConfig(**CFG))
    return ref, params, port, convert.from_reference(_np_tree(params))


def _ref_model(impl):
    return r_ba.BlockAttentionAE(r_ba.BlockAttentionConfig(**CFG, attn_impl=impl))


def test_config_validates():
    with pytest.raises(ValueError, match="divisible"):
        t_ba.BlockAttentionConfig(**dict(CFG, n_heads=3))
    with pytest.raises(ValueError, match="attn_impl"):
        t_ba.BlockAttentionConfig(**CFG, attn_impl="pallas")
    cfg = t_ba.BlockAttentionConfig(**CFG)
    assert cfg.arch == ARCH and cfg.n_tokens == 16 and cfg.token_dim == 20


def test_convert_roundtrip_and_defs(ae_pair):
    _, params, port, state = ae_pair
    tree = _np_tree(params)
    assert set(state) == set(port.params())
    assert "enc_block0.attn.wq" in state and "dec_block0.ln1.scale" in state
    for name, p in port.params().items():
        assert tuple(state[name].shape) == tuple(p.shape), name
    back = convert.to_reference(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port.defs == jax.tree.map(lambda a: tuple(a.shape), tree)
    with pytest.raises(KeyError, match="unknown parameter"):
        convert.from_reference({"enc_block0": {"attn": {"wz": tree["enc_proj"]["w"]}}})
    with pytest.raises(KeyError, match="unknown parameter"):
        convert.to_reference({"scale": state["enc_norm.scale"]})


@pytest.mark.parametrize("param_dtype_bytes", [4, 2])
def test_decoder_stream_bytes_equal_reference(ae_pair, param_dtype_bytes):
    _, params, _, state = ae_pair
    tree = _np_tree(params)
    want, _ = r_params.pack_artifact_params(tree, None, param_dtype_bytes)
    got, corr = t_params.pack_artifact_params(convert.to_reference(state), None,
                                              param_dtype_bytes)
    assert corr is None and got == want
    dec_defs = t_families.ATTENTION.decoder_defs(
        t_ba.BlockAttentionAE(t_ba.BlockAttentionConfig(**CFG)))
    back = t_params.unpack_params(got, dec_defs, param_dtype_bytes)
    ref_back = r_params.unpack_params(
        want, r_families.ATTENTION.decoder_defs(_ref_model("direct")),
        param_dtype_bytes)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["direct", "flash"])
def test_encode_decode_match(reference_pallas_load, ae_pair, impl):  # noqa: F811
    _, params, port, state = ae_pair
    ref = _ref_model(impl)
    x = _blocks()
    want_z = np.array(ref.encode(params, jnp.asarray(x)))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x), state, impl).numpy()
    np.testing.assert_allclose(z, want_z, atol=1e-5, rtol=0)
    want = np.asarray(ref.decode(params, jnp.asarray(want_z)))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(want_z), state, impl).numpy()
    assert got.shape == want.shape == (12, S, *BLOCK)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["direct", "flash"])
def test_loss_and_grads_match(reference_pallas_load, ae_pair, impl):  # noqa: F811
    ref, params, port, state = ae_pair
    x = _blocks(8, seed=5)
    want_loss = float(r_ba._loss(_ref_model(impl))(params, jnp.asarray(x)))
    want_g = convert.from_reference(_np_tree(
        jax.grad(r_ba._loss(ref))(params, jnp.asarray(x))))
    leaves = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    loss = t_ba.ae_loss(port, impl)(leaves, torch.from_numpy(x))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_fit_matches_on_reference_indices(ae_pair):
    ref, _, port, _ = ae_pair
    blocks = _blocks(40, seed=7)
    steps, bs, seed = 5, 8, 0
    want_p, want_losses = r_ba.fit(ref, blocks, steps=steps, batch_size=bs,
                                   lr=2e-3, seed=seed)
    idx = r_loop.all_batch_indices(seed, steps, blocks.shape[0], bs)
    start = convert.from_reference(_np_tree(ref.init(jax.random.PRNGKey(seed))))
    got_p, losses = t_ba.fit(port, blocks, steps=steps, batch_size=bs, lr=2e-3,
                             seed=seed, params=start, indices=idx, device="cpu")
    assert losses.dtype == np.float32 and losses.shape == (steps,)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    want_p = convert.from_reference(_np_tree(want_p))
    for name in got_p:
        np.testing.assert_allclose(got_p[name].numpy(), want_p[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_init_law_and_seed_reproducibility():
    cfg = t_ba.BlockAttentionConfig(**dict(CFG, d_model=64, mlp_hidden=128))
    a, b = t_ba.init_params(cfg, 3, "cpu"), t_ba.init_params(cfg, 3, "cpu")
    c = t_ba.init_params(cfg, 4, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["enc_block0.attn.wq"], c["enc_block0.attn.wq"])
    assert float(a["dec_proj.bias"].abs().max()) == 0.0
    assert torch.equal(a["enc_norm.scale"], torch.ones(64))
    for name in ("enc_block0.attn.wq", "dec_block0.ffn.wd", "enc_head.weight"):
        w = a[name]  # (out, in): fan_in is the second axis
        np.testing.assert_allclose(float(w.std()), 1 / np.sqrt(w.shape[1]),
                                   rtol=0.1, err_msg=name)


@pytest.mark.parametrize("with_corr", [True, False])
def test_fused_decode_vecs_match(reference_pallas_load, ae_pair, with_corr):  # noqa: F811
    from repro.core import correction as r_corr

    _, params, _, state = ae_pair
    cref = r_corr.TensorCorrectionNetwork(r_corr.CorrectionConfig(n_species=S))
    cparams = cref.init(jax.random.PRNGKey(1))
    cport = t_corr.TensorCorrectionNetwork(t_corr.CorrectionConfig(n_species=S))
    cstate = convert.from_reference(_np_tree(cparams))
    z = np.random.default_rng(4).normal(size=(12, LATENT)).astype(np.float32)
    want = np.asarray(r_families.make_fused_decode(
        _ref_model("flash"), cref if with_corr else None)(
            params, cparams if with_corr else None, jnp.asarray(z)))
    scfg = t_families.structural(PipelineConfig(**dict(PIPE_KW, latent=LATENT)))
    model = t_families.ATTENTION.build_model(scfg, S, "cpu")
    assert model.cfg.attn_impl == "flash"
    fused = t_families.make_fused_decode(model, cport if with_corr else None)
    with torch.no_grad():
        got = fused(state, cstate if with_corr else None, torch.from_numpy(z))
    assert got.shape == want.shape == (S, 12, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# -- the codec end to end on the CPU ------------------------------------------
@pytest.fixture(scope="module")
def data():
    return s3d.generate(s3d.S3DConfig(
        n_species=S, n_time=16, height=20, width=16, seed=7))["species"]


@pytest.fixture(scope="module")
def port_report(data):
    return GBATCCodec(PipelineConfig(**PIPE_KW), device="cpu").compress_report(
        data, target_nrmse=BOUND)


@pytest.fixture(scope="module")
def reference_report(reference_x64, data):  # noqa: F811
    return r_codec.GBATCCodec(RefConfig(**PIPE_KW)).compress_report(
        data, target_nrmse=BOUND)


@pytest.fixture(scope="module")
def conv_blob(data):
    cfg = PipelineConfig(ae_steps=8, corr_steps=4, conv_channels=(8, 16), seed=0)
    return GBATCCodec(cfg, device="cpu").compress(data, target_nrmse=BOUND)


def _nrmse(data, field):
    return np.array([metrics.nrmse(data[s], field[s]) for s in range(S)])


def test_port_blob_is_v5_attention_and_meets_bound(port_report, data):
    blob, rep = port_report
    r = ContainerReader(blob)
    assert r.version == 5 and r["meta"][:1] == bytes([2])
    assert (rep.per_species_nrmse <= BOUND).all()
    field = t_codec.decompress(blob, device="cpu")
    np.testing.assert_array_equal(field, rep.recon)
    assert (_nrmse(data, field) <= BOUND * (1 + 1e-3)).all()
    assert len(blob) == rep.bytes_breakdown["total"]


def test_port_blob_decodes_in_reference(reference_x64, port_report, data):  # noqa: F811
    blob, rep = port_report
    field = r_codec.decompress(blob)
    assert (_nrmse(data, field) <= BOUND * (1 + 1e-3)).all()
    np.testing.assert_allclose(field, rep.recon, rtol=0,
                               atol=1e-4 * np.abs(rep.recon).max())


def test_reference_blob_decodes_in_port(reference_report, data):
    blob, rep = reference_report
    assert ContainerReader(blob)["meta"][:1] == bytes([2])
    field = t_codec.decompress(blob, device="cpu")
    assert field.shape == data.shape and field.dtype == np.float32
    nrmse = _nrmse(data, field)
    # the worst per-species excess over the bound (negative: none), shown
    # with ``pytest -s``
    print(f"attention, reference blob decoded by the port: max NRMSE "
          f"{float(nrmse.max())!r}, excess over the target "
          f"{nrmse.max() / BOUND - 1:+.3e}, largest change from the "
          f"reference's own decode {np.abs(nrmse - rep.per_species_nrmse).max():.3e}")
    assert (nrmse <= BOUND * (1 + 1e-3)).all()
    np.testing.assert_allclose(field, rep.recon, rtol=0,
                               atol=1e-4 * np.abs(rep.recon).max())


def test_blobs_share_stream_tables(reference_report, port_report):
    a, b = ContainerReader(reference_report[0]), ContainerReader(port_report[0])
    assert a.version == b.version == 5 and a.names == b.names
    assert len(a["decoder"]) == len(b["decoder"])
    assert len(a["correction"]) == len(b["correction"])
    meta_a = t_wire._unpack_meta(a["meta"], version=5)
    meta_b = t_wire._unpack_meta(b["meta"], version=5)
    assert meta_a[0] == meta_b[0] and meta_a[1] == meta_b[1]
    assert meta_b[0].family == "attention" and meta_b[0].arch == ARCH


# -- wire strictness and isolation ------------------------------------------
def _resign_v5(blob: bytes, mutate) -> bytes:
    """Re-emit a v5 container with ``mutate(name, payload)`` applied and the
    integrity stream recomputed, so structural checks are reached instead
    of a digest tripping first."""
    r = ContainerReader(blob)
    w = t_container.ContainerWriter(version=r.version)
    for name in r.names:
        if name != "integrity":
            payload = mutate(name, r[name])
            w.add(name, payload if payload is not None else r[name])
    streams = list(w._streams)
    integ = t_wire.pack_integrity_stream(streams)
    header = t_container.pack_header(
        r.version, [(n, len(p)) for n, p in streams] + [("integrity", len(integ))])
    w.add("integrity", t_wire.finalize_integrity_stream(integ, header))
    return w.to_bytes()


def test_unknown_family_tag_raises_with_coordinates(conv_blob):
    bad = _resign_v5(conv_blob,
                     lambda n, p: bytes([99]) + p[1:] if n == "meta" else None)
    with pytest.raises(ContainerFormatError, match="unknown encoder family tag 99") as ei:
        t_codec.decompress(bad, device="cpu")
    assert ei.value.stream == "meta" and ei.value.offset == 0
    with pytest.raises(ValueError, match="unknown encoder family"):
        t_families.get("no-such-family")


def test_retagged_meta_fails_arch_validation(conv_blob):
    bad = _resign_v5(conv_blob,
                     lambda n, p: bytes([2]) + p[1:] if n == "meta" else None)
    with pytest.raises(ContainerFormatError, match="bad attention arch") as ei:
        t_codec.decompress(bad, device="cpu")
    assert ei.value.stream == "meta"


def test_family_param_stream_mismatch_raises(conv_blob, port_report):
    conv_dec = ContainerReader(conv_blob)["decoder"]
    bad = _resign_v5(port_report[0],
                     lambda n, p: conv_dec if n == "decoder" else None)
    with pytest.raises(ContainerFormatError) as ei:
        t_codec.decompress(bad, device="cpu")
    assert ei.value.stream == "decoder"


def test_runtime_keys_and_runtimes_never_alias(conv_blob, port_report):
    from repro_torch.core import blocking

    mk = lambda fam: t_families.StructuralConfig(  # noqa: E731
        family=fam, geometry=blocking.BlockGeometry(bt=4, ph=4, pw=4),
        latent=8, arch=ARCH, use_correction=True, param_dtype_bytes=2)
    k_conv = t_runtime._runtime_key(mk("conv"), 4, True, torch.device("cpu"))
    k_attn = t_runtime._runtime_key(mk("attention"), 4, True, torch.device("cpu"))
    assert k_conv[0] == "conv" and k_attn[0] == "attention"
    assert k_conv[1:] == k_attn[1:]
    head_c = t_runtime._cached_head(conv_blob, device="cpu")
    head_a = t_runtime._cached_head(port_report[0], device="cpu")
    assert head_c.runtime is not head_a.runtime
    assert type(head_a.runtime.model) is t_ba.BlockAttentionAE
    assert head_a.runtime.model.cfg.attn_impl == "flash"


def test_registry_matches_reference():
    assert t_families.registered() == r_families.registered() == (
        ("conv", 1), ("attention", 2))
    assert t_families.DEFAULT_ATTENTION_ARCH == r_families.DEFAULT_ATTENTION_ARCH
    for arch in ((32, 2, 1, 64), (32, 3, 1, 64), (8, 16), (16, 2, 1, 32, 1)):
        assert (t_families.ATTENTION.validate_arch(arch) is None) == (
            r_families.ATTENTION.validate_arch(arch) is None)
    with pytest.raises(ValueError, match="bad attention arch"):
        t_families.structural(PipelineConfig(family="attention", arch=(30, 4, 1, 8)))
