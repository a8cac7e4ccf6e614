"""The port's mesh-sharded fit and compress (``repro_torch.parallel``).

Mirrors the reference's ``tests/test_mesh.py`` and the gradient-compression
cases of ``tests/test_distribution.py`` on the port, on the CPU with meshes
that name the CPU more than once (``Mesh(("cpu",) * 4)``, the port's
counterpart of the reference's forced host devices):

* the trainer's 1-device mesh fit is bitwise the plain fit, quantised
  exchange too; the caller's params survive mesh fits; replicas are
  bitwise equal at P = 4; rows and batches are trimmed as the reference
  trims them, indivisible extents raise;
* the P = 4 trajectory (fp32 and int8 exchange) agrees with the
  reference's own 4-device DP fit, run in a subprocess on a forced
  4-device host, fed the reference's per-shard index streams: within
  ``TRAJ_ATOL`` (measured: 1.5e-8 in params, 1.2e-7 in losses);
* the exchange: ``quantized_psum`` bitwise the reference's under
  ``jax.vmap(..., axis_name="data")``, the int8 payload exact, one bucket
  quantised with the bits of leaf-by-leaf quantisation; ``compress_tree``'s
  error feedback;
* ``dp_wire_report`` and ``_chunk_plan`` equal to the reference's;
* the sharded engine's container byte-identical to the default engine's
  across shard counts, meshes and both select backends;
* ``ShardedBlockStore``; the mesh ``fit_stream`` (P = 1: the plain
  streamed blob, no full-field host buffer; P = 4: bound met, decode
  bitwise, latents bitwise the one-device encode); the attention family's
  DP fit.
"""

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import gradient_compression as r_gc
from repro.parallel import mesh_fit as r_mf
from repro.train import train_loop as r_tl
from repro_torch import codec as t_codec
from repro_torch.core import pipeline as t_pipeline
from repro_torch.core.pipeline import GBATCCodec, GBATCPipeline, PipelineConfig
from repro_torch.data import s3d
from repro_torch.parallel import Mesh, gather_rows, host_mesh, mesh_cache_key, shard_rows
from repro_torch.parallel import gradient_compression as t_gc
from repro_torch.parallel import mesh_fit as t_mf
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU1 = Mesh(("cpu",))
CPU4 = Mesh(("cpu",) * 4)
TRAJ_ATOL = 1e-6  # P = 4 params and losses against the reference's DP fit
STEPS = 12


def _problem(seed=0):
    """The reference's tiny linear-AE problem (``tests/test_mesh.py``):
    the same data and initial params, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((32, 12)).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"w_enc": np.asarray(jax.random.normal(k1, (12, 4)) * 0.1),
              "w_dec": np.asarray(jax.random.normal(k2, (4, 12)) * 0.1)}
    return params, x


def _loss(p, batch):
    rec = batch @ p["w_enc"] @ p["w_dec"]
    return torch.mean(torch.square(rec - batch))


def _tparams(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _trainer(lr=1e-3, steps=6):
    return t_tl.MiniBatchTrainer(_loss, t_opt.adamw_cfg(lr, steps))


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# mesh plumbing
# ---------------------------------------------------------------------------
class TestMesh:
    def test_mesh_resolves_and_may_repeat(self):
        m = Mesh(("cpu", torch.device("cpu")))
        assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2
        assert mesh_cache_key(m) == ("cpu", "cpu")
        with pytest.raises(ValueError, match="at least one"):
            Mesh(())

    def test_host_mesh_raises_when_devices_are_missing(self):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        with pytest.raises(ValueError, match="available"):
            host_mesh(n + 1)

    def test_shard_rows_copies_and_gather_rows_reassembles(self):
        x = torch.arange(24.0).reshape(8, 3)
        shards = shard_rows(x, CPU4)
        assert [s.shape[0] for s in shards] == [2] * 4
        shards[0][0, 0] = -1.0  # a copy, never a view of the caller's array
        assert x[0, 0] == 0.0
        x[0, 0] = -1.0
        for r0, r1 in [(0, 8), (1, 7), (2, 4), (3, 4), (5, 8)]:
            assert torch.equal(gather_rows(shards, r0, r1, "cpu"), x[r0:r1])
        with pytest.raises(ValueError, match="do not divide"):
            shard_rows(np.zeros((9, 3), np.float32), CPU4)


# ---------------------------------------------------------------------------
# (1) the data-parallel trainer
# ---------------------------------------------------------------------------
class TestDPTrainer:
    def test_p1_mesh_fit_bitwise_plain(self):
        """A 1-device mesh runs the plain loop: losses and every param
        bitwise the plain fit's, with the quantised exchange too."""
        params, x = _problem()
        tr = _trainer()
        kw = dict(steps=6, batch_size=8, seed=0)
        p_ref, l_ref = tr.fit(_tparams(params), (x,), device="cpu", **kw)
        for q in (False, True):
            p, l = tr.fit(_tparams(params), (x,), mesh=CPU1,
                          quantized_exchange=q, **kw)
            assert np.array_equal(l, l_ref)
            assert _equal(p, p_ref)

    @pytest.mark.parametrize("mesh", [CPU1, CPU4], ids=["P1", "P4"])
    def test_caller_params_intact_after_two_mesh_fits(self, mesh):
        params, x = _problem()
        caller = _tparams(params)
        before = {k: v.clone() for k, v in caller.items()}
        tr = _trainer(steps=4)
        for seed in (0, 1):
            tr.fit(caller, (x,), steps=4, batch_size=8, seed=seed, mesh=mesh)
        assert _equal(caller, before)

    @pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
    def test_p4_replicas_bitwise_equal_and_training(self, quantized):
        """Odd row counts are trimmed (35 -> 32 rows); the replicas end
        bitwise equal and the loss falls (the mean of the last five steps
        below the first five's: single batch losses are noisy)."""
        params, x = _problem()
        x_odd = np.concatenate([x, x[:3]])
        tr = _trainer(lr=1e-2, steps=40)
        p, losses = tr.fit(_tparams(params), (x_odd,), steps=40,
                           batch_size=16, seed=0, mesh=CPU4,
                           quantized_exchange=quantized)
        assert np.isfinite(losses).all()
        assert losses[-5:].mean() < 0.8 * losses[:5].mean()
        reps = tr.last_replicas
        assert len(reps) == 4 and _equal(reps[0], p)
        assert all(_equal(r, reps[0]) for r in reps[1:])
        assert all(r[k] is not reps[0][k] for r in reps[1:] for k in r)

    def test_trimming_matches_the_reference(self, monkeypatch):
        """Global rows trim to a multiple of P, the batch to max((bs // P)
        P, P) (``train_loop.py:315-352`` of the reference)."""
        seen = []
        real = t_mf.dp_fit

        def spy(trainer, params, shards, **kw):
            seen.append((kw["n"], kw["bs"], [s[0].shape[0] for s in shards]))
            return real(trainer, params, shards, **kw)

        monkeypatch.setattr(t_mf, "dp_fit", spy)
        params, x = _problem()
        tr = _trainer(steps=2)
        for rows, bs, mesh in [(35, 16, CPU4), (35, 7, Mesh(("cpu",) * 3)),
                               (5, 64, CPU4), (32, 2, CPU4)]:
            tr.fit(_tparams(params), (np.resize(x, (rows, 12)),), steps=2,
                   batch_size=bs, seed=0, mesh=mesh)
        assert seen == [(32, 16, [8] * 4), (33, 6, [11] * 3), (4, 4, [1] * 4),
                        (32, 4, [8] * 4)]

    def test_indivisible_extents_raise(self):
        params, x = _problem()
        tr = _trainer(steps=4)
        shards = [(torch.from_numpy(x[8 * i:8 * i + 8]),) for i in range(4)]
        with pytest.raises(ValueError, match="must divide"):
            t_mf.dp_fit(tr, _tparams(params), shards, steps=4, n=33, bs=8,
                        seed=0, log_every=0, mesh=CPU4, quantized=False)
        with pytest.raises(ValueError, match="cannot shard"):
            tr.fit(_tparams(params), (x[:3],), steps=4, batch_size=8, seed=0,
                   mesh=CPU4)
        with pytest.raises(ValueError, match="equal row shards"):
            tr.fit(_tparams(params), ([torch.from_numpy(x)] * 3,), steps=4,
                   batch_size=8, seed=0, mesh=CPU4)
        with pytest.raises(ValueError, match="indices has shape"):
            tr.fit(_tparams(params), (x,), steps=4, batch_size=8, seed=0,
                   mesh=CPU4, indices=np.zeros((4, 4, 8), np.int64))

    def test_presharded_data_is_the_whole_arrays(self):
        """Row shards handed in directly train as the whole array does."""
        params, x = _problem()
        tr = _trainer(steps=4)
        kw = dict(steps=4, batch_size=8, seed=3, mesh=CPU4)
        p_whole, l_whole = tr.fit(_tparams(params), (x,), **kw)
        p_shard, l_shard = tr.fit(_tparams(params), (shard_rows(x, CPU4),), **kw)
        assert np.array_equal(l_whole, l_shard) and _equal(p_whole, p_shard)


def _reference_indices(seed, p, steps, n_local, bs_local):
    """The reference's per-shard index streams: ``batch_indices`` under
    ``fold_in(batch_key(seed), i)`` (``mesh_fit.py:151-158``)."""
    bkey = r_tl.batch_key(seed)
    return np.stack([
        np.stack([np.asarray(r_tl.batch_indices(jax.random.fold_in(bkey, i), t,
                                                n_local, bs_local))
                  for t in range(steps)])
        for i in range(p)])


_REFERENCE_DP_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.parallel import mesh_fit
from repro.train import train_loop

x = np.asarray(json.loads(sys.argv[1]), np.float32)
params = {k: jnp.asarray(np.asarray(v, np.float32))
          for k, v in json.loads(sys.argv[2]).items()}

def loss_fn(p, batch):
    rec = batch @ p["w_enc"] @ p["w_dec"]
    return jnp.mean(jnp.square(rec - batch))

assert len(jax.devices()) == 4
out = {}
for q in (False, True):
    tr = train_loop.MiniBatchTrainer(
        loss_fn, train_loop.adamw_cfg(5e-3, %(steps)d), mode="scan")
    p, l = tr.fit(params, (x,), steps=%(steps)d, batch_size=8, seed=0,
                  mesh=mesh_fit.host_mesh(4), quantized_exchange=q)
    out[str(q)] = {"losses": np.asarray(l).tolist(),
                   **{k: np.asarray(v).tolist() for k, v in p.items()}}
print(json.dumps(out))
""" % {"steps": STEPS}


@pytest.fixture(scope="module")
def reference_dp():
    """The reference's own 4-device DP fit of ``_problem``, fp32 and int8
    exchange, in a subprocess on a forced 4-device CPU host."""
    params, x = _problem()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_DP_SCRIPT, json.dumps(x.tolist()),
         json.dumps({k: v.tolist() for k, v in params.items()})],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {q == "True": {k: np.asarray(v, np.float32) for k, v in r.items()}
            for q, r in res.items()}


class TestReferenceTrajectory:
    @pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
    def test_p4_trajectory_matches_reference_dp_fit(self, reference_dp, quantized):
        params, x = _problem()
        idx = _reference_indices(0, 4, STEPS, 8, 2)
        tr = _trainer(lr=5e-3, steps=STEPS)
        p, losses = tr.fit(_tparams(params), (x,), steps=STEPS, batch_size=8,
                           seed=0, mesh=CPU4, quantized_exchange=quantized,
                           indices=idx)
        ref = reference_dp[quantized]
        gap = max(np.abs(losses - ref["losses"]).max(),
                  *(np.abs(p[k].numpy() - ref[k]).max() for k in p))
        print(f"\n{'int8' if quantized else 'fp32'} exchange: largest gap to "
              f"the reference's DP fit {gap:.3e}")
        assert gap <= TRAJ_ATOL

    @pytest.mark.parametrize("shape", [(48,), (64,), (4, 12), (1000,), (3, 7, 13)])
    def test_quantized_psum_bitwise_reference(self, shape):
        """Against the reference's exchange body under ``jax.vmap`` on one
        device (every member of the vmapped axis gets the same sum)."""
        rng = np.random.default_rng(sum(shape))
        x = rng.standard_normal((4,) + shape).astype(np.float32)
        want = np.asarray(jax.vmap(partial(r_gc.quantized_psum, axis="data"),
                                   axis_name="data")(jnp.asarray(x)))
        got = t_gc.quantized_psum([torch.from_numpy(x[i]) for i in range(4)])
        for i in range(4):
            assert got[i].shape == shape
            assert np.array_equal(got[i].numpy(), want[i])

    def test_quantized_all_reduce_over_a_mesh(self):
        rng = np.random.default_rng(7)
        x = rng.standard_normal((8, 100)).astype(np.float32)
        got = t_gc.quantized_all_reduce(x, CPU4)
        want = t_gc.quantized_psum(
            [torch.from_numpy(x[2 * i:2 * i + 2]) for i in range(4)])
        assert len(got) == 4
        assert all(torch.equal(g, w) for g, w in zip(got, want))


class TestExchange:
    def test_payload_is_exact(self):
        """q = round(values / scales) gives the kernel's values back
        bitwise as q * s, at 8 bits and fewer."""
        rng = np.random.default_rng(0)
        x = torch.from_numpy((rng.standard_normal(1000) * 1e3).astype(np.float32))
        x[:64] = 0.0  # an all-zero block (scale 1e-30 / qmax)
        for n_bits in (8, 4, 2):
            q, s = t_gc.quantize_payload(x, n_bits=n_bits, block=64)
            values = t_gc._quant_dequant(x, n_bits, 64)
            assert q.dtype == torch.int8 and s.shape == (16,)
            qmax = 2 ** (n_bits - 1) - 1
            assert int(q.max()) <= qmax and int(q.min()) >= -qmax - 1
            back = (q.float() * s[:, None]).reshape(-1)[:1000]
            assert torch.equal(back, values)
        with pytest.raises(ValueError, match="int8"):
            t_gc.quantize_payload(x, n_bits=12)

    def test_bucket_quantises_as_leaf_by_leaf(self):
        """One bucket of zero-padded leaves: the same payload bits as
        quantising every leaf alone (a conv bias of 32 is one padded
        block)."""
        rng = np.random.default_rng(1)
        grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for k, s in [("bias", (32,)), ("w", (3, 5)), ("full", (64,)),
                              ("conv", (7, 13, 3))]}
        q, s = t_gc.quantize_payload(t_mf.pack_bucket(grads, 64))
        per_leaf = [t_gc.quantize_payload(g) for g in grads.values()]
        assert torch.equal(q, torch.cat([p[0] for p in per_leaf]))
        assert torch.equal(s, torch.cat([p[1] for p in per_leaf]))
        back = t_mf.unpack_bucket(t_mf.pack_bucket(grads, 64), grads, 64)
        assert _equal(back, grads)

    def test_error_feedback_accumulates(self):
        """Sum of compressed grads + final residual == sum of raw grads
        (EF telescopes); each step bitwise the reference's compress_tree."""
        rng = np.random.default_rng(0)
        g0 = {"w": rng.normal(size=(64, 64)).astype(np.float32)}
        res = t_gc.init_residuals(_tparams(g0))
        r_res = r_gc.init_residuals({"w": jnp.asarray(g0["w"])})
        cfg = t_gc.CompressionConfig(n_bits=4, block=32)
        r_cfg = r_gc.CompressionConfig(n_bits=4, block=32)
        total_raw = np.zeros((64, 64), np.float32)
        total_comp = np.zeros((64, 64), np.float32)
        for _ in range(10):
            g = rng.normal(size=(64, 64)).astype(np.float32)
            total_raw += g
            cg, res = t_gc.compress_tree({"w": torch.from_numpy(g)}, res, cfg)
            r_cg, r_res = r_gc.compress_tree({"w": jnp.asarray(g)}, r_res, r_cfg)
            assert np.array_equal(cg["w"].numpy(), np.asarray(r_cg["w"]))
            assert np.array_equal(res["w"].numpy(), np.asarray(r_res["w"]))
            total_comp += cg["w"].numpy()
        np.testing.assert_allclose(total_comp + res["w"].numpy(), total_raw,
                                   rtol=1e-5, atol=1e-5)

    def test_per_step_error_bounded(self):
        rng = np.random.default_rng(1)
        g = {"w": torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))}
        cg, _ = t_gc.compress_tree(g, t_gc.init_residuals(g),
                                   t_gc.CompressionConfig(n_bits=8, block=64))
        err = np.abs(cg["w"].numpy() - g["w"].numpy())
        scale = np.abs(g["w"].numpy()).reshape(2, 64).max(1) / 127.0
        assert (err.reshape(2, 64) <= scale[:, None] * 0.5 + 1e-7).all()

    def test_disabled_passthrough(self):
        g = {"w": torch.ones(8)}
        res = t_gc.init_residuals(g)
        cg, res2 = t_gc.compress_tree(g, res, t_gc.CompressionConfig(enabled=False))
        assert cg is g and res2 is res


class TestWireReport:
    def test_static_accounting_equals_reference(self):
        params = {"a": np.zeros(64, np.float32), "b": np.zeros(10, np.float32)}
        for p in (8, 4, 1):
            assert t_mf.dp_wire_report(params, p) == r_mf.dp_wire_report(params, p)
        rep = t_mf.dp_wire_report(params, 8)
        assert rep["quantized_bytes_per_step"] == (68 + 68) * 7
        assert t_mf.dp_wire_report(params, 1)["wire_ratio"] == float("inf")

    def test_conv_ae_equals_reference(self):
        """The port's flat state_dict of the conv AE against the
        reference's param tree of the same model, at P = 4."""
        from repro.core import autoencoder as r_ae
        from repro_torch.core import autoencoder as t_ae

        kw = dict(n_species=58, block=(4, 5, 4), latent=36, conv_channels=(32, 64))
        t_cfg, r_cfg = t_ae.AEConfig(**kw), r_ae.AEConfig(**kw)
        t_params = t_ae.init_params(t_cfg, 0, "cpu")
        r_params = r_ae.BlockAutoencoder(r_cfg).init(jax.random.PRNGKey(0))
        assert t_mf.dp_wire_report(t_params, 4) == r_mf.dp_wire_report(r_params, 4)


# ---------------------------------------------------------------------------
# (2) the sharded guarantee engine
# ---------------------------------------------------------------------------
SWEEP = [(s, nb, n) for s in (1, 2, 4, 7) for nb in (1, 5, 32)
         for n in (1, 2, 3, 5, 8, 13, 64)]


def test_chunk_plan_equals_reference_and_covers_exactly():
    for s, nb, n in SWEEP:
        chunks = t_mf._chunk_plan(s, nb, n)
        assert chunks == r_mf._chunk_plan(s, nb, n), (s, nb, n)
        cover = np.zeros((s, nb), np.int32)
        for s0, s1, r0, r1 in chunks:
            assert s1 - s0 == 1 or (r0, r1) == (0, nb)  # contiguous chunks
            cover[s0:s1, r0:r1] += 1
        assert (cover == 1).all(), (s, nb, n)


SCFG = dict(n_species=4, n_time=8, height=20, width=16, seed=5)  # NB = 32
PCFG = dict(ae_steps=30, corr_steps=15, conv_channels=(8, 16))


@pytest.fixture(scope="module")
def small_data():
    return s3d.generate(s3d.S3DConfig(**SCFG))["species"]


@pytest.fixture(scope="module")
def fitted_pipe(small_data):
    pipe = GBATCPipeline(PipelineConfig(**PCFG), n_species=4, device="cpu")
    pipe.fit(small_data)
    return pipe


class TestShardedEngine:
    @pytest.mark.parametrize("backend", ["host", "device"])
    def test_container_byte_identity(self, fitted_pipe, backend):
        """Shard counts 1, 2, 3, S, 2S+1 (rows split past S) on meshes of 1
        and 4 devices: the container of the default engine, byte for
        byte."""
        from repro_torch.core import gae

        s = fitted_pipe.n_species
        try:
            fitted_pipe.set_guarantee_engine(
                gae.GuaranteeEngine("cpu", select_backend=backend))
            ref = fitted_pipe.compress(target_nrmse=1e-3).artifact.to_bytes()
            for mesh in (CPU1, CPU4):
                for n in (1, 2, 3, s, 2 * s + 1):
                    fitted_pipe.set_guarantee_engine(t_mf.ShardedGuaranteeEngine(
                        mesh=mesh, n_shards=n, select_backend=backend))
                    got = fitted_pipe.compress(target_nrmse=1e-3).artifact.to_bytes()
                    assert got == ref, (mesh.size, n)
        finally:
            fitted_pipe.set_guarantee_engine(gae.default_engine("cpu"))

    def test_replay_and_staging(self, fitted_pipe):
        """apply_batched through the chunked dispatch is the default
        engine's; staged tensors stay on the host."""
        from repro_torch.core import gae

        rep = fitted_pipe.compress(target_nrmse=1e-3)
        arts = rep.artifact.species_guarantees
        entry = next(iter(fitted_pipe._prepared.values()))[0]
        want = gae.default_engine("cpu").apply_batched(entry.x_rec32, arts)
        eng = t_mf.ShardedGuaranteeEngine(mesh=Mesh(("cpu",) * 2), n_shards=9)
        assert np.array_equal(eng.apply_batched(entry.x_rec32, arts), want)
        staged = eng._stage(np.zeros((2, 3), np.float32))
        assert isinstance(staged, torch.Tensor) and staged.device.type == "cpu"
        with pytest.raises(ValueError, match="n_shards"):
            t_mf.ShardedGuaranteeEngine(n_shards=-1, device="cpu")


# ---------------------------------------------------------------------------
# (3) the sharded landing buffer
# ---------------------------------------------------------------------------
class TestShardedBlockStore:
    def test_fill_and_finish(self):
        store = t_mf.ShardedBlockStore(8, (3,), CPU1)
        parts = [np.full((4, 3), i, np.float32) for i in range(2)]
        store.append(parts[0])
        with pytest.raises(ValueError, match="4 of 8"):
            store.finish()
        store.append(parts[1])
        (buf,) = store.finish()
        assert np.array_equal(buf.numpy(), np.concatenate(parts))
        with pytest.raises(ValueError, match="overflows"):
            store.append(np.zeros((1, 3), np.float32))
        assert store.per_device_bytes() == {"cpu": buf.numel() * 4}

    def test_rejects_indivisible_rows(self):
        with pytest.raises(ValueError, match="does not divide"):
            t_mf.ShardedBlockStore(33, (3,), CPU4)

    def test_straddling_chunks_match_concat(self):
        """Chunks of 3 rows over shards of 8: writes split at shard
        boundaries."""
        store = t_mf.ShardedBlockStore(32, (5,), CPU4)
        rng = np.random.default_rng(0)
        parts = [rng.standard_normal((r, 5)).astype(np.float32)
                 for r in (3, 3, 7, 1, 9, 9)]
        for p in parts:
            store.append(p)
        shards = store.finish()
        assert [s.shape[0] for s in shards] == [8] * 4
        assert np.array_equal(torch.cat(shards).numpy(), np.concatenate(parts))
        assert store.per_device_bytes() == {"cpu": 32 * 5 * 4}


# ---------------------------------------------------------------------------
# the pipeline's mesh branch
# ---------------------------------------------------------------------------
def _spy_host_alloc(monkeypatch):
    allocs = []
    orig = t_pipeline._host_alloc

    def spy(shape, dtype):
        allocs.append(int(np.prod(shape)) * np.dtype(dtype).itemsize)
        return orig(shape, dtype)

    monkeypatch.setattr(t_pipeline, "_host_alloc", spy)
    return allocs


class TestMeshPipeline:
    def test_p1_fit_stream_blob_is_the_plain_one(self, monkeypatch):
        """On a 1-device mesh the streamed fit/compress (sharded store, DP
        trainer, sharded engine) writes the plain streamed blob, and never
        touches the host block buffer that the plain path fills."""
        allocs = _spy_host_alloc(monkeypatch)
        loader = s3d.S3DChunkLoader(s3d.S3DConfig(**SCFG), chunk_frames=4)
        cfg = PipelineConfig(**PCFG)
        meshed = GBATCCodec(cfg, mesh=CPU1).fit_stream(loader)
        assert allocs == [], "mesh fit_stream touched the host block buffer"
        got = meshed.compress(target_nrmse=1e-3)
        plain = GBATCCodec(cfg, device="cpu").fit_stream(loader)
        assert allocs == [32 * 4 * cfg.geometry.block_size * 4]
        assert got == plain.compress(target_nrmse=1e-3)

    def test_p4_fit_stream(self, monkeypatch):
        """P = 4: bound met, the blob decodes to the report's recon bitwise,
        the latents are bitwise the one-device encode of the same params,
        and the latent stream of the per-shard parts is the whole array's."""
        allocs = _spy_host_alloc(monkeypatch)
        loader = s3d.S3DChunkLoader(s3d.S3DConfig(**SCFG), chunk_frames=4)
        gb = GBATCCodec(PipelineConfig(**PCFG), mesh=CPU4).fit_stream(loader)
        pipe = gb.pipeline
        assert allocs == []
        shards = pipe._block_shards
        assert [s.shape[0] for s in shards] == [8] * 4
        one_device = pipe._encode(pipe._ae_params, torch.cat(shards))
        assert np.array_equal(pipe._latents, one_device)
        blob, rep = gb.compress_report(target_nrmse=1e-3)
        assert pipe._block_shards is None  # copied to the host, then freed
        assert (rep.per_species_nrmse <= 1e-3 * (1 + 1e-3)).all()
        assert np.array_equal(t_codec.decompress(blob, device="cpu"), rep.recon)
        art = rep.artifact
        assert len(art._latent_parts) == 4
        whole = t_codec.pack_latent_stream(art.latent_q, 5)
        assert art.sharded_latent_stream(5) == whole

    def test_p4_fit_in_memory_and_indivisible_rows(self, small_data):
        gb = GBATCCodec(PipelineConfig(**PCFG), mesh=CPU4)
        blob, rep = gb.compress_report(small_data, target_nrmse=1e-3)
        assert (rep.per_species_nrmse <= 1e-3 * (1 + 1e-3)).all()
        assert np.array_equal(t_codec.decompress(blob, device="cpu"), rep.recon)
        with pytest.raises(ValueError, match="do not divide"):
            GBATCCodec(PipelineConfig(**PCFG), mesh=Mesh(("cpu",) * 3)).fit(small_data)
        with pytest.raises(ValueError, match="first device"):
            GBATCPipeline(PipelineConfig(**PCFG), 4, device="meta", mesh=CPU4)

    def test_attention_family_dp_fit(self, small_data):
        cfg = PipelineConfig(family="attention", arch=(16, 2, 1, 32),
                             ae_steps=6, corr_steps=4, batch_size=16)
        gb = GBATCCodec(cfg, mesh=Mesh(("cpu",) * 2))
        blob, rep = gb.compress_report(small_data, target_nrmse=1e-3)
        assert (rep.per_species_nrmse <= 1e-3 * (1 + 1e-3)).all()
        assert np.array_equal(t_codec.decompress(blob, device="cpu"), rep.recon)
