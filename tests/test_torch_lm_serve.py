"""The port's LM serving layer against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_serve.py`` on the port (same
names, same checks), and beside them: greedy ``Server.generate`` tokens
equal to the reference ``Server``'s on the same parameters and batch for
every config, a sampled generate that repeats for one seed,
``ServeStats`` equal, ``QuantizedKVCache`` payload and scales bitwise the
reference's, the int8 cache through ``Server``, the KV room check, and
``python -m repro_torch.launch.serve --device cpu`` running to its print.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import registry as r_reg
from repro.serve import kvcache as r_kv
from repro.serve import serve_loop as r_serve
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models.registry import build_model, make_batch
from repro_torch.serve import Server
from repro_torch.serve import serve_loop as t_serve
from repro_torch.serve.kvcache import QuantizedKVCache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_setup(arch):
    cfg = r_base.get_config(arch).smoke()
    model = r_reg.build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def setup():
    """The reference's llama3_2_1b smoke setup and the port's on the same
    parameters."""
    rcfg, rmodel, rparams = _ref_setup("llama3_2_1b")
    cfg = get_config("llama3_2_1b").smoke()
    params = convert.lm_from_reference(jax.tree.map(np.asarray, rparams), "cpu")
    return cfg, build_model(cfg), params, (rcfg, rmodel, rparams)


class TestServer:
    def test_generate_shapes_and_determinism(self, setup):
        cfg, model, params, _ = setup
        server = Server(model, params, max_len=64, device="cpu")
        batch = make_batch(cfg, batch=3, seq=16, kind="prefill", seed=5, device="cpu")
        out1 = server.generate(batch, 8)
        out2 = Server(model, params, max_len=64, device="cpu").generate(batch, 8)
        assert out1.shape == (3, 8) and out1.dtype == np.int32
        np.testing.assert_array_equal(out1, out2)  # greedy => deterministic
        assert (out1 >= 0).all() and (out1 < cfg.vocab).all()

    def test_generate_matches_incremental_prefill(self, setup):
        """Greedy decode must equal re-prefilling with the grown sequence."""
        cfg, model, params, _ = setup
        server = Server(model, params, max_len=64, device="cpu")
        batch = make_batch(cfg, batch=2, seq=12, kind="prefill", seed=6, device="cpu")
        out = server.generate(batch, 3)
        grown = {"tokens": torch.cat([batch["tokens"], torch.from_numpy(out[:, :2])], 1)}
        logits, _ = model.prefill(params, grown, max_len=64)
        np.testing.assert_array_equal(out[:, 2], logits[:, -1].argmax(-1).numpy())

    @pytest.mark.parametrize("arch", r_base.list_configs())
    def test_greedy_tokens_equal_reference(self, arch):
        """The port's Server and the reference's, same parameters and batch:
        the same greedy tokens, and ServeStats counted alike."""
        rcfg, rmodel, rparams = _ref_setup(arch)
        rbatch = r_reg.make_batch(rcfg, batch=3, seq=10, kind="prefill", seed=8)
        rserver = r_serve.Server(rmodel, rparams, max_len=32)
        want = rserver.generate(rbatch, 6)
        cfg = get_config(arch).smoke()
        server = Server(build_model(cfg),
                        convert.lm_from_reference(jax.tree.map(np.asarray, rparams), "cpu"),
                        max_len=32, device="cpu")
        batch = make_batch(cfg, batch=3, seq=10, kind="prefill", seed=8, device="cpu")
        np.testing.assert_array_equal(server.generate(batch, 6), want)
        assert dataclasses.asdict(server.stats) == dataclasses.asdict(rserver.stats)

    def test_serve_stats_equal_reference(self, setup):
        """Two generates, a zero-token one among them: the counters move as
        the reference's do."""
        cfg, model, params, (rcfg, rmodel, rparams) = setup
        rserver = r_serve.Server(rmodel, rparams, max_len=40)
        server = Server(model, params, max_len=40, device="cpu")
        for n_new, b in ((5, 2), (0, 3), (2, 1)):
            rserver.generate(r_reg.make_batch(rcfg, batch=b, seq=9, kind="prefill"), n_new)
            out = server.generate(make_batch(cfg, batch=b, seq=9, kind="prefill",
                                             device="cpu"), n_new)
            assert out.shape == (b, n_new)
        assert dataclasses.asdict(server.stats) == dataclasses.asdict(rserver.stats)
        assert dataclasses.asdict(server.stats) == {
            "prefill_tokens": 9 * 6, "decode_tokens": 12, "steps": 7}
        assert [f.name for f in dataclasses.fields(t_serve.ServeStats)] == \
            [f.name for f in dataclasses.fields(r_serve.ServeStats)]

    def test_sampled_generate_repeats_for_a_seed(self, setup):
        cfg, model, params, _ = setup
        batch = make_batch(cfg, batch=4, seq=8, kind="prefill", seed=2, device="cpu")
        runs = [Server(model, params, max_len=64, device="cpu").generate(
            batch, 12, greedy=False, seed=s) for s in (3, 3, 4)]
        np.testing.assert_array_equal(runs[0], runs[1])
        assert not np.array_equal(runs[0], runs[2])
        assert ((runs[0] >= 0) & (runs[0] < cfg.vocab)).all()
        greedy = Server(model, params, max_len=64, device="cpu").generate(batch, 12)
        assert not np.array_equal(runs[0], greedy)

    def test_kv_cache_room_is_checked(self, setup):
        cfg, model, params, _ = setup
        batch = make_batch(cfg, batch=1, seq=10, kind="prefill", device="cpu")
        assert Server(model, params, max_len=14, device="cpu").generate(batch, 4).shape == (1, 4)
        with pytest.raises(ValueError, match="max_len"):
            Server(model, params, max_len=14, device="cpu").generate(batch, 5)

    @pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b"])
    def test_kv_quant_server(self, arch):
        """kv_quant through Server: the prefill cache quantised into the
        int8 layout, tokens in range and mostly the dense path's."""
        cfg = get_config(arch).smoke()
        dense = build_model(cfg)
        params = dense.init(0, "cpu")
        batch = make_batch(cfg, batch=3, seq=10, kind="prefill", seed=4, device="cpu")
        want = Server(dense, params, max_len=32, device="cpu").generate(batch, 6)
        got = Server(build_model(cfg.replace(kv_quant=True)), params, max_len=32,
                     device="cpu").generate(batch, 6)
        assert got.shape == want.shape and ((got >= 0) & (got < cfg.vocab)).all()
        assert (got == want).mean() >= 0.5


class TestQuantKVDecodePath:
    def test_int8_decode_close_to_dense(self, setup):
        """cfg.kv_quant decode_step must track the dense path closely (the
        quantization bound propagated through one attention layer)."""
        cfg, model, params, _ = setup
        batch = make_batch(cfg, batch=2, seq=10, kind="prefill", seed=9, device="cpu")
        _, cache = model.prefill(params, batch, max_len=24)
        qmodel = build_model(cfg.replace(kv_quant=True))
        qcache = qmodel.quantize_cache(cache)
        tok = batch["tokens"][:, :1]
        l_dense, _ = model.decode_step(params, cache, tok)
        l_quant, qc2 = qmodel.decode_step(params, qcache, tok)
        assert int(qc2["len"]) == 11
        a, b = l_dense.numpy(), l_quant.numpy()
        assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 0.05
        assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5


class TestQuantizedKV:
    def test_append_and_bound(self):
        qc = QuantizedKVCache.create(2, 3, 16, 4, 8, device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(5):
            k = torch.from_numpy(rng.normal(size=(2, 3, 1, 4, 8)).astype(np.float32))
            v = torch.from_numpy(rng.normal(size=(2, 3, 1, 4, 8)).astype(np.float32))
            qc = qc.append(k, v)
        assert int(qc.length) == 5
        k_deq, _ = qc.dequant_layer(0, dtype=torch.float32)
        err = (k_deq[:, 4] - k[0][:, 0]).abs()
        kb, _ = qc.max_abs_error_bound()
        assert float(err.max()) <= float(kb) + 1e-7

    def test_pytree_registered(self):
        """The reference registers the cache as a pytree of five leaves; the
        port's is a dataclass of five tensors that rebuilds from them."""
        qc = QuantizedKVCache.create(1, 1, 4, 1, 8, device="cpu")
        leaves = [getattr(qc, f.name) for f in dataclasses.fields(qc)]
        assert len(leaves) == 5 and all(isinstance(t, torch.Tensor) for t in leaves)
        qc2 = QuantizedKVCache(*leaves)
        assert isinstance(qc2, QuantizedKVCache) and qc2.k_q is qc.k_q

    def test_payload_and_scales_bitwise_reference(self):
        """create + five appends + dequant: int8 payload, fp32 scales and the
        error bound bit for bit the reference's on the same inputs."""
        rng = np.random.default_rng(1)
        ref = r_kv.QuantizedKVCache.create(2, 3, 8, 2, 16)
        port = QuantizedKVCache.create(2, 3, 8, 2, 16, device="cpu")
        for step in range(5):
            scale = 10.0 ** (step - 2)
            k, v = (scale * rng.normal(size=(2, 3, 1, 2, 16)).astype(np.float32)
                    for _ in range(2))
            if step == 3:
                k[0, 0, 0, 0] = 0.0  # an all-zero row: the 1e-30 floor
            ref = ref.append(jnp.asarray(k), jnp.asarray(v))
            port = port.append(torch.from_numpy(k), torch.from_numpy(v))
        for name, rname in (("k_q", "k_q"), ("v_q", "v_q"), ("k_scale", "k_scale"),
                            ("v_scale", "v_scale"), ("length", "length")):
            got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, rname))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        for layer in (0, 1):
            for got, want in zip(port.dequant_layer(layer, torch.float32),
                                 ref.dequant_layer(layer, jnp.float32)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(port.max_abs_error_bound(), ref.max_abs_error_bound()):
            assert float(got) == float(want)


def test_launch_serve_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("generated (2, 4) in ")
    assert lines[1].startswith("sample: [") and len(eval(lines[1][8:])) == 4


@pytest.mark.parametrize("arch", ["whisper_base", "rwkv6_7b", "recurrentgemma_2b",
                                  "qwen2_vl_7b"])
def test_launch_serve_main_every_family(arch, capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--new-tokens", "3"])
    assert out.shape == (2, 3)
    assert capsys.readouterr().out.startswith("generated (2, 3) in ")
