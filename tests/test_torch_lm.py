"""The port's language models against the JAX package's, on the CPU.

For every one of the ten configs' ``.smoke()``: the reference's
``init(PRNGKey(0))`` parameters carried across by
``convert.lm_from_reference``, the inputs from both packages'
``make_batch(seed=...)``; prefill logits and every cache leaf, three
``decode_step``s (logits and caches) and ``loss`` held against the
reference under both ``use_kernels`` settings (True runs the kernels'
plain versions, since the tensors lie on the CPU); ``scan_layers`` runs
one loop over the stacked layer axis in the port either way, so each
config asserts once that both settings give the same bits. Tolerance: fp32, rtol = atol = 1e-4 — the packages sum in
other orders (matmul vs einsum, the RG-LRU's doubling scan vs
``associative_scan``, the kernels' plain versions vs the portable
formulas); prefill and first-step decode logits were seen to differ by at
most 5.2e-6 on a CPU.

Also: the reference's prefill/decode consistency case mirrored, the int8
KV decode path, MoE at ``capacity_factor=1.0`` with drops, the chunked
attention branch at small chunks, partial RoPE and M-RoPE, the meta
specs of every (config, shape) cell, every field of every config, and
``lm_from_reference`` with its inverse.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import common as r_common
from repro.models import registry as r_reg
from repro.models import transformer as r_tf
from repro.nn import module as r_module
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import rglru_scan as t_rglru
from repro_torch.kernels import rwkv6_scan as t_rwkv6
from repro_torch.models import common as t_common
from repro_torch.models import registry as t_reg
from repro_torch.models import transformer as t_tf
from repro_torch.nn import module as t_module

ARCHS = r_base.list_configs()
DECODER_LM = [a for a in ARCHS if r_base.get_config(a).family in ("dense", "moe", "vlm")]
MOE = [a for a in ARCHS if r_base.get_config(a).family == "moe"]
VARIANTS = [pytest.param(True, id="kernels"), pytest.param(False, id="portable")]
TOL = dict(rtol=1e-4, atol=1e-4)
T_PROMPT, T_TRAIN, N_STEPS = 12, 16, 3


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _assert_tree_close(port, ref, path="", **tol):
    """Same keys, dtypes and shapes at every level; values within ``tol``
    (exactly for integer leaves)."""
    tol = tol or TOL
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), (path, port.keys())
        for k in ref:
            _assert_tree_close(port[k], ref[k], f"{path}/{k}", **tol)
        return
    got, want = _np(port), np.asarray(ref)
    assert got.dtype.name == want.dtype.name, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _step_tokens(vocab, step):
    return np.random.default_rng(100 + step).integers(0, vocab, (2, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_runs():
    """Per arch, computed once: the reference's parameters (numpy), prefill
    logits and cache, three decode steps, and the loss."""
    runs = {}

    def get(arch):
        if arch not in runs:
            cfg = r_base.get_config(arch).smoke()
            model = r_reg.build_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            batch = r_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7)
            logits, cache = jax.jit(model.prefill)(params, batch)
            out = {"tree": jax.tree.map(np.asarray, params),
                   "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache)}
            decode = jax.jit(model.decode_step)
            steps = []
            for step in range(N_STEPS):
                tok = _step_tokens(cfg.vocab, step)
                logits, cache = decode(params, cache, jnp.asarray(tok))
                steps.append((tok, np.asarray(logits), jax.tree.map(np.asarray, cache)))
            out["steps"] = steps
            train = r_reg.make_batch(cfg, batch=2, seq=T_TRAIN, kind="train", seed=1)
            out["loss"] = float(jax.jit(model.loss)(params, train))
            runs[arch] = out
        return runs[arch]

    return get


def _port(arch, use_kernels=True, scan_layers=True, **kw):
    cfg = t_base.get_config(arch).smoke().replace(
        use_kernels=use_kernels, scan_layers=scan_layers, **kw)
    return cfg, t_reg.build_model(cfg)


# -- prefill, decode, loss against the reference ------------------------------
@pytest.mark.parametrize("use_kernels", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, use_kernels, ref_runs):
    ref = ref_runs(arch)
    cfg, model = _port(arch, use_kernels)
    params = convert.lm_from_reference(ref["tree"], "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7,
                             device="cpu")
    logits, cache = model.prefill(params, batch)
    _assert_tree_close(logits, ref["logits"], "logits")
    _assert_tree_close(cache, ref["cache"], "cache")


@pytest.mark.parametrize("use_kernels", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, use_kernels, ref_runs):
    ref = ref_runs(arch)
    cfg, model = _port(arch, use_kernels)
    params = convert.lm_from_reference(ref["tree"], "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7,
                             device="cpu")
    _, cache = model.prefill(params, batch)
    for step, (tok, want_logits, want_cache) in enumerate(ref["steps"]):
        logits, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        _assert_tree_close(logits, want_logits, f"step {step} logits")
        _assert_tree_close(cache, want_cache, f"step {step} cache")


@pytest.mark.parametrize("use_kernels", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, use_kernels, ref_runs):
    ref = ref_runs(arch)
    cfg, model = _port(arch, use_kernels)
    params = convert.lm_from_reference(ref["tree"], "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=T_TRAIN, kind="train", seed=1,
                             device="cpu")
    loss = model.loss(params, batch)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_layers_settings_agree(arch, ref_runs):
    """Both ``scan_layers`` settings give the same bits in prefill, a
    decode step and the loss (the port has one loop for both)."""
    params = convert.lm_from_reference(ref_runs(arch)["tree"], "cpu")
    outs = []
    for scan_layers in (True, False):
        cfg, model = _port(arch, scan_layers=scan_layers)
        batch = t_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7,
                                 device="cpu")
        logits, cache = model.prefill(params, batch)
        step, cache = model.decode_step(params, cache,
                                        torch.from_numpy(_step_tokens(cfg.vocab, 0)))
        train = t_reg.make_batch(cfg, batch=2, seq=T_TRAIN, kind="train", seed=1,
                                 device="cpu")
        outs.append({"logits": logits, "step": step, "cache": cache,
                     "loss": model.loss(params, train)})
    _assert_tree_close(outs[1], outs[0], rtol=0, atol=0)


@pytest.mark.parametrize("use_kernels", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, use_kernels, ref_runs):
    """tests/test_models_smoke.py's case on the port: decode_step after
    prefill(T) matches prefill(T+1)'s last logits."""
    cfg, model = _port(arch, use_kernels)
    params = convert.lm_from_reference(ref_runs(arch)["tree"], "cpu")
    t = 12
    full = t_reg.make_batch(cfg, batch=2, seq=t + 1, kind="prefill", seed=7, device="cpu")
    pre = {k: (v[:, :t] if k == "tokens" else v) for k, v in full.items()}
    logits_pre, cache = model.prefill(params, pre)
    assert logits_pre.shape[:2] == (2, 1) and torch.isfinite(logits_pre).all()
    logits_dec, cache2 = model.decode_step(params, cache, full["tokens"][:, t:t + 1])
    assert logits_dec.shape[:2] == (2, 1) and torch.isfinite(logits_dec).all()
    prefix = cfg.n_patches if cfg.is_vlm else 0  # VLM caches patch KV too
    assert int(cache2["len"]) == t + 1 + prefix
    logits_full, _ = model.prefill(params, full)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_kernel_route_on_cpu_launches_no_kernel(ref_runs):
    """On CPU tensors the kernel route runs the plain versions: the CUDA
    wrappers' counts stay 0 (they only count launches on the card)."""
    for mod in (t_flash, t_rwkv6, t_rglru):
        mod.reset_launches()
    for arch in ("llama3_2_1b", "rwkv6_7b", "recurrentgemma_2b", "whisper_base"):
        cfg, model = _port(arch)
        params = model.init(0, "cpu")
        model.prefill(params, t_reg.make_batch(cfg, batch=1, seq=8, kind="prefill",
                                               device="cpu"))
    for mod in (t_flash, t_rwkv6, t_rglru):
        assert not any(mod.launch_counts().values())


# -- int8 KV decode ----------------------------------------------------------
@pytest.mark.parametrize("arch", DECODER_LM)
def test_kv_quant_decode_matches_reference(arch, ref_runs):
    """kv_quant decode on the dense prefill cache quantised into the int8
    layout: the reference's quantisation by hand (tests/test_serve.py), the
    port's ``quantize_cache``; logits and every cache leaf agree (int8
    payload exactly, scales to fp32 rounding)."""
    ref = ref_runs(arch)
    rcfg = r_base.get_config(arch).smoke()
    rparams = jax.tree.map(jnp.asarray, ref["tree"])
    cache = jax.tree.map(jnp.asarray, ref["cache"])
    kq, ks = r_tf._quant_kv(cache["k"])
    vq, vs = r_tf._quant_kv(cache["v"])
    qcache = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs, "len": cache["len"]}
    if "pos_next" in cache:
        qcache["pos_next"] = cache["pos_next"]
    tok = _step_tokens(rcfg.vocab, 0)
    want_logits, want_cache = jax.jit(r_reg.build_model(
        rcfg.replace(kv_quant=True)).decode_step)(rparams, qcache, jnp.asarray(tok))

    cfg, model = _port(arch, kv_quant=True)
    params = convert.lm_from_reference(ref["tree"], "cpu")
    batch = t_reg.make_batch(cfg, batch=2, seq=T_PROMPT, kind="prefill", seed=7,
                             device="cpu")
    _, dense = model.prefill(params, batch)
    port_q = model.quantize_cache(dense)
    _assert_tree_close({k: port_q[k] for k in ("k_q", "v_q")}, {"k_q": kq, "v_q": vq})
    logits, new_cache = model.decode_step(params, port_q, torch.from_numpy(tok))
    _assert_tree_close(logits, np.asarray(want_logits), "logits")
    _assert_tree_close(new_cache, jax.tree.map(np.asarray, want_cache), "cache")
    assert int(new_cache["len"]) == int(cache["len"]) + 1


# -- MoE at capacity_factor 1.0 ----------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_drops_match_reference(arch, ref_runs):
    """At capacity_factor = 1.0 random routers overflow experts: the
    port drops the same assignments (stable sort, cumsum slots) and its
    layer and model outputs match the reference's."""
    ref = ref_runs(arch)
    rcfg = r_base.get_config(arch).smoke().replace(capacity_factor=1.0)
    cfg, model = _port(arch, capacity_factor=1.0)
    ffn = {k: v[0] for k, v in ref["tree"]["layers"]["ffn"].items()}
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want_y, want_aux = r_tf._moe_forward(rcfg, jax.tree.map(jnp.asarray, ffn),
                                         jnp.asarray(x))
    tffn = {k: torch.from_numpy(np.array(v)) for k, v in ffn.items()}
    y, aux = t_tf._moe_forward(cfg, tffn, torch.from_numpy(x))
    *_, keep = t_tf.moe_dispatch(cfg, tffn, torch.from_numpy(x).reshape(-1, cfg.d_model))
    assert int((~keep).sum()) > 0, "no assignment was dropped"
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    rmodel = r_reg.build_model(rcfg)
    batch = r_reg.make_batch(rcfg, batch=2, seq=T_TRAIN, kind="prefill", seed=3)
    want_logits, want_cache = jax.jit(rmodel.prefill)(
        jax.tree.map(jnp.asarray, ref["tree"]), batch)
    logits, cache = model.prefill(convert.lm_from_reference(ref["tree"], "cpu"),
                                  _to_torch(batch))
    _assert_tree_close(logits, np.asarray(want_logits), "logits")
    _assert_tree_close(cache, jax.tree.map(np.asarray, want_cache), "cache")


# -- attention, rotary -------------------------------------------------------
# (tq, tk, causal, window, q_offset, q_chunk, k_chunk): ragged chunks on both
# axes, causal, windowed, offset queries, Tq != Tk
CHUNKED = [(37, 37, True, 0, 0, 8, 16), (37, 37, True, 5, 0, 16, 8),
           (20, 45, False, 0, 0, 8, 16), (10, 13, True, 0, 3, 4, 4),
           (33, 33, False, 7, 0, 32, 5)]


@pytest.mark.parametrize("tq,tk,causal,window,q_offset,q_chunk,k_chunk", CHUNKED)
def test_chunked_attention_matches_reference(tq, tk, causal, window, q_offset,
                                             q_chunk, k_chunk):
    rng = np.random.default_rng(tq + tk + window)
    q = rng.normal(size=(2, tq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, tk, 4, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=q_chunk,
              k_chunk=k_chunk)
    want = r_common._chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = t_common._chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tq,tk,hkv,causal,window", [
    (24, 24, 1, True, 0), (24, 24, 2, True, 5), (24, 9, 4, False, 0)])
def test_flash_route_matches_reference_attention(tq, tk, hkv, causal, window):
    """``attention(use_kernels=True)`` (repeat_kv, (B, H, T, D), the flash
    op; on the CPU its plain version) against the reference's attention."""
    rng = np.random.default_rng(tq * tk + hkv)
    q = rng.normal(size=(2, tq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, tk, hkv, 16)).astype(np.float32) for _ in range(2))
    want = r_common.attention(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    got = t_common.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                             window=window, use_kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="q_offset"):
        t_common.attention(*map(torch.from_numpy, (q, k, v)), q_offset=1,
                           use_kernels=True)


@pytest.mark.parametrize("d,frac,theta", [(16, 1.0, 1e6), (80, 0.25, 1e4), (16, 0.5, 5e5)])
def test_apply_rope_matches_reference(d, frac, theta):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, frac)
    got = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_common.rope_freqs(d, theta, frac).numpy(),
                               np.asarray(r_common.rope_freqs(d, theta, frac)), rtol=1e-6)


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    want = r_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2))
    got = t_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        t_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 2, 1))


def test_decode_attention_and_cross_entropy_match_reference():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 20, 2, 16)).astype(np.float32) for _ in range(2))
    for window in (0, 6):
        want = r_common.decode_attention(*map(jnp.asarray, (q, k, v)), 13, window=window)
        got = t_common.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                        torch.tensor(13, dtype=torch.int32), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    logits = rng.normal(size=(2, 5, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(t_common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(r_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


# -- specs, configs, conversion ----------------------------------------------
def _dtype_name(dt):
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


def _assert_specs_equal(port, ref, path=""):
    """Meta tensors against ShapeDtypeStructs, structure for structure."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), (path, list(port))
        for k in ref:
            _assert_specs_equal(port[k], ref[k], f"{path}/{k}")
        return
    assert port.device.type == "meta", path
    assert tuple(port.shape) == tuple(ref.shape), (path, port.shape, ref.shape)
    assert _dtype_name(port.dtype) == _dtype_name(ref.dtype), (path, port.dtype, ref.dtype)


CELLS = [(a, s) for a in ARCHS for s in r_base.get_config(a).shapes]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    _assert_specs_equal(t_reg.input_specs(t_base.get_config(arch), shape),
                        r_reg.input_specs(r_base.get_config(arch), shape))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv_quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, kv_quant):
    rcfg = r_base.get_config(arch).replace(kv_quant=kv_quant)
    tcfg = t_base.get_config(arch).replace(kv_quant=kv_quant)
    for batch, max_len in ((128, 32768), (2, 40)):
        _assert_specs_equal(t_reg.build_model(tcfg).cache_specs(batch, max_len),
                            r_reg.build_model(rcfg).cache_specs(batch, max_len))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """The full config's parameter tree: every path, shape and dtype, and
    the bytes the port reckons from meta tensors before allocating."""
    rmodel = r_reg.build_model(r_base.get_config(arch))
    tmodel = t_reg.build_model(t_base.get_config(arch))
    specs = tmodel.specs()
    _assert_specs_equal(t_module.nest(specs), rmodel.specs())
    assert t_module.param_bytes(tmodel.defs) == r_module.param_bytes(rmodel.defs)
    assert sum(t.numel() * t.element_size() for t in specs.values()) == \
        r_module.param_bytes(rmodel.defs)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference(arch):
    """Every field equal, except the dtype (torch for jnp) and the
    documented use_kernels default (True in the port, False in the
    reference)."""
    ref, port = _fields(r_base.get_config(arch)), _fields(t_base.get_config(arch))
    assert sorted(ref) == sorted(port)
    assert _dtype_name(port.pop("dtype")) == _dtype_name(ref.pop("dtype")) == "bfloat16"
    assert port.pop("use_kernels") is True and ref.pop("use_kernels") is False
    assert port == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch):
    ref = _fields(r_base.get_config(arch).smoke())
    port = _fields(t_base.get_config(arch).smoke())
    assert _dtype_name(port.pop("dtype")) == _dtype_name(ref.pop("dtype")) == "float32"
    assert port.pop("use_kernels") is True and ref.pop("use_kernels") is False
    assert port == ref
    assert t_base.get_config(arch).shapes == r_base.get_config(arch).shapes


def test_config_registry_matches_reference():
    assert t_base.list_configs() == r_base.list_configs()
    assert t_base.SHAPES == {k: t_base.ShapeSpec(*dataclasses.astuple(v))
                             for k, v in r_base.SHAPES.items()}
    assert t_base.get_config("llama3.2-1b") is t_base.get_config("llama3_2_1b")
    with pytest.raises(KeyError, match="unknown arch"):
        t_base.get_config("gpt5")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_from_reference_round_trip(arch, ref_runs):
    tree = ref_runs(arch)["tree"]
    params = convert.lm_from_reference(tree, "cpu")
    assert list(params) == [".".join(p) for p, _ in convert._leaves(tree)]
    back = convert.lm_to_reference(params)
    _assert_tree_close(back, tree, rtol=0, atol=0)
    again = convert.lm_from_reference(back, "cpu")
    assert all(torch.equal(again[k], params[k]) for k in params)


def test_lm_from_reference_bf16_leaves():
    """bf16 trees (the full configs' dtype) cross bit for bit."""
    cfg = r_base.get_config("stablelm_3b").smoke().replace(dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, r_reg.build_model(cfg).init(jax.random.PRNGKey(1)))
    params = convert.lm_from_reference(tree, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers.ln1.scale"].dtype == torch.float32
    back = convert.lm_to_reference(params)
    for path, leaf in convert._leaves(tree):
        got = back
        for key in path:
            got = got[key]
        assert got.dtype == leaf.dtype and np.array_equal(
            got.view(np.uint8), np.asarray(leaf).view(np.uint8)), path


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b", "rwkv6_7b",
                                  "recurrentgemma_2b"])
def test_init_is_seeded_and_follows_the_laws(arch):
    """Deterministic in (seed, path); zeros and ones exact; LeCun normal
    std 1/sqrt(fan-in of the per-layer shape); the RG-LRU's Lambda in
    its (0.9, 0.999)^(1/8) logit range."""
    cfg, model = _port(arch)
    a, b, c = model.init(0, "cpu"), model.init(0, "cpu"), model.init(1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    for path, p in t_module.walk(model.defs):
        t = a[".".join(path)]
        assert tuple(t.shape) == p.full_shape and t.dtype == p.dtype
        if p.init == "zeros":
            assert not t.any()
        elif p.init == "ones":
            assert (t == 1).all()
        elif p.init == "fan_in" and t.numel() >= 2000:
            fan = p.shape[0] if len(p.shape) == 1 else int(np.prod(p.shape[:-1]))
            assert abs(float(t.float().std()) * np.sqrt(fan) - 1.0) < 0.1, path
        elif callable(p.init):  # the RG-LRU's Lambda
            lo, hi = (np.log(u ** 0.125 / (1 - u ** 0.125)) for u in (0.9, 0.999))
            assert float(t.min()) >= lo - 1e-4 and float(t.max()) <= hi + 1e-4
    # every path and every stacked layer draws its own numbers
    drawn = [a[".".join(path)] for path, p in t_module.walk(model.defs)
             if p.init == "fan_in"]
    rows = [t.reshape(-1)[:64] for t in drawn] + [
        t[1].reshape(-1)[:64] for t in drawn if t.dim() > 2 and t.shape[0] > 1]
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)
