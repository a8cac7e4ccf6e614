"""The port's training infrastructure against the JAX package's, on the CPU.

* ``data/tokens.py``: ``TokenPipeline`` bitwise the reference's over seeds,
  steps and shards, and the reference's ``TestTokenPipeline`` cases;
* ``train/checkpoint.py``: the reference's ``TestCheckpointManager`` cases
  on the port's ``CheckpointManager``; checkpoints carried across both
  ways (the reference's bf16 leaves come back from ``np.savez`` as ``|V2``
  words; the port writes bf16 the same way, under manifest dtype
  "bfloat16", and the optimizer's step as the reference's int32 scalar);
  ``compress_state_bytes`` on the reference test's data giving the
  reference's reconstruction bitwise and its byte count;
* ``train/fault_tolerance.py`` with the port's manager: the reference's
  ``TestFaultTolerance`` cases, and a crash-and-resume run of the port's
  train step (``launch.train.train``) on a smoke model bitwise equal to
  the uninterrupted run;
* ``python -m repro_torch.launch.train --device cpu``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gae import reference_x64  # noqa: F401  (module-scoped shim fixture)

from repro.configs import base as r_base
from repro.data import tokens as r_tokens
from repro.models import registry as r_reg
from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as r_opt
from repro.train import train_loop as r_tl
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch import train as t_launch
from repro_torch.models import registry as t_reg
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_loop as t_tl
from repro_torch.train.checkpoint import CheckpointManager, compress_state_bytes
from repro_torch.train.fault_tolerance import StepFailure, Watchdog, run_with_recovery

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# -- token pipeline --------------------------------------------------------
@pytest.mark.parametrize("seed,n_shards,vocab", [(0, 1, 50), (1, 2, 100),
                                                (7, 4, 128256), (3, 1, 30)])
def test_token_pipeline_matches_reference(seed, n_shards, vocab):
    for shard in range(n_shards):
        kw = dict(vocab=vocab, batch=8, seq_len=24, seed=seed, n_shards=n_shards,
                  shard=shard)
        port = TokenPipeline(TokenPipelineConfig(**kw))
        ref = r_tokens.TokenPipeline(r_tokens.TokenPipelineConfig(**kw))
        for step in (0, 1, 17, 1000):
            got, want = port.batch_at(step), ref.batch_at(step)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


class TestTokenPipeline:
    def test_deterministic_per_step(self):
        cfg = TokenPipelineConfig(vocab=100, batch=8, seq_len=32, seed=1)
        b1, b2 = TokenPipeline(cfg).batch_at(17), TokenPipeline(cfg).batch_at(17)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])

    def test_shards_partition_batch(self):
        kw = dict(vocab=100, batch=8, seq_len=16, seed=2, n_shards=2)
        b0 = TokenPipeline(TokenPipelineConfig(shard=0, **kw)).batch_at(3)
        assert b0["tokens"].shape == (4, 16)
        b1 = TokenPipeline(TokenPipelineConfig(shard=1, **kw)).batch_at(3)
        assert not np.array_equal(b0["tokens"], b1["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = TokenPipeline(TokenPipelineConfig(vocab=50, batch=2, seq_len=10)).batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- checkpoint manager ----------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))},
            "step": 7}


class TestCheckpointManager:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        tree = _tree()
        mgr.save(5, tree)
        restored, step = mgr.restore(tree)
        assert step == 5 and restored["step"] == 7
        assert torch.equal(restored["a"]["w"], tree["a"]["w"])

    def test_corruption_detected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        tree = _tree()
        path = mgr.save(1, tree)
        npz = os.path.join(path, "arrays.npz")
        data = dict(np.load(npz))
        data["a/w"] = data["a/w"] + 1.0
        np.savez(npz, **data)
        with pytest.raises(IOError, match="corruption"):
            mgr.restore(tree)

    def test_gc_keeps_last_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
        for s in range(5):
            mgr.save(s, _tree())
        assert mgr.all_steps() == [3, 4]
        assert mgr.latest_step() == 4

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_write=True)
        mgr.save(9, _tree())
        mgr.wait()
        assert mgr.latest_step() == 9

    def test_gbatc_compressed_checkpoint(self, reference_x64):  # noqa: F811
        """The reference's case on the port (the guarantee engine on the
        CPU): ratio > 2x, every 256-block within the bound; and the
        reference's reconstruction bitwise and its byte count."""
        rng = np.random.default_rng(3)
        flat = {f"layer{i}/w": rng.normal(size=(256, 128)).astype(np.float32)
                for i in range(3)}
        rec, nbytes, report = compress_state_bytes(flat, tau_rel=1e-2, device="cpu")
        assert report["ratio"] > 2.0
        for k in flat:
            blocks = flat[k].reshape(-1, 256)
            norms = np.linalg.norm(blocks - rec[k].reshape(-1, 256), axis=1)
            rms = np.sqrt(np.mean(blocks**2))
            assert norms.max() <= 1e-2 * rms * np.sqrt(256) * (1 + 1e-6)
        want_rec, want_bytes, want_report = r_ckpt.compress_state_bytes(flat, tau_rel=1e-2)
        assert nbytes == want_bytes and report == want_report
        for k in flat:
            assert rec[k].dtype == want_rec[k].dtype
            np.testing.assert_array_equal(rec[k], want_rec[k])


def test_compress_state_bytes_keeps_small_and_integer_leaves(reference_x64):  # noqa: F811
    rng = np.random.default_rng(4)
    flat = {"small": rng.normal(size=(1000,)).astype(np.float32),
            "ints": np.arange(4096, dtype=np.int32),
            "odd": rng.normal(size=(7, 300)).astype(np.float32)}  # padded tail
    rec, nbytes, report = compress_state_bytes(flat, tau_rel=1e-3, device="cpu")
    want_rec, want_bytes, want_report = r_ckpt.compress_state_bytes(flat, tau_rel=1e-3)
    assert rec["small"] is flat["small"] and rec["ints"] is flat["ints"]
    assert (nbytes, report) == (want_bytes, want_report)
    # the artifacts are the reference's bit for bit (tests/test_torch_gae.py);
    # the fp32 sum x + C U^T may round differently in the last place, the
    # engine tests' atol
    np.testing.assert_allclose(rec["odd"], want_rec["odd"], rtol=0, atol=1e-6)


def test_compress_state_bytes_bound_at_1e3_allows_only_fp32_storage(
        reference_x64):  # noqa: F811
    """At tau_rel 1e-3 the engine meets tau in fp64; storing the corrected
    block in fp32 rounds each element by half an ulp, so a block may land
    past tau (1 + 1e-6), the reference test's slack, by up to
    2^-24 |rec block| (ROADMAP C-ref-13) and by no more. The reference
    gives the same bits, so it misses tau (1 + 1e-6) by the same blocks:
    on these seeded weights, one block of 16,384."""
    rng = np.random.default_rng(1)
    v = (rng.normal(size=(1024, 4096)) * 0.02
         + rng.normal(size=(1, 4096)) * 0.001).astype(np.float32)
    rec, nbytes, report = compress_state_bytes({"w": v}, tau_rel=1e-3, device="cpu")
    blocks, rblocks = v.reshape(-1, 256), rec["w"].reshape(-1, 256)
    norms = np.linalg.norm(blocks - rblocks, axis=1)
    tau = 1e-3 * np.sqrt(np.mean(blocks**2)) * np.sqrt(256)
    assert (norms <= tau * (1 + 1e-6) + 2.0**-24 * np.linalg.norm(rblocks, axis=1)).all()
    assert (norms <= tau * (1 + 1e-4)).all() and report["ratio"] > 2.0
    want_rec, want_bytes, want_report = r_ckpt.compress_state_bytes({"w": v}, tau_rel=1e-3)
    assert (nbytes, report) == (want_bytes, want_report)
    assert rec["w"].dtype == want_rec["w"].dtype
    assert rec["w"].tobytes() == want_rec["w"].tobytes()
    want_norms = np.linalg.norm(blocks - want_rec["w"].reshape(-1, 256), axis=1)
    missed = np.flatnonzero(norms > tau * (1 + 1e-6))
    assert missed.size == 1
    np.testing.assert_array_equal(missed,
                                  np.flatnonzero(want_norms > tau * (1 + 1e-6)))


def test_compress_state_bytes_bf16_leaf_matches_reference(reference_x64):  # noqa: F811
    """A bf16 leaf (``|V2`` in the port, ``ml_dtypes`` in the reference):
    the same bytes out and the same byte count."""
    import ml_dtypes

    x = np.random.default_rng(5).normal(size=(64, 64)).astype(ml_dtypes.bfloat16)
    rec, nbytes, _ = compress_state_bytes({"w": x.view("V2")}, 1e-3, device="cpu")
    want_rec, want_bytes, _ = r_ckpt.compress_state_bytes({"w": x}, 1e-3)
    assert rec["w"].dtype == np.dtype("V2") and nbytes == want_bytes
    assert rec["w"].tobytes() == want_rec["w"].tobytes()


def test_flatten_tree_keys_follow_the_reference():
    """Dotted parameter names become paths: the port's flat dict gives the
    reference's keys for its nested tree."""
    cfg = r_base.get_config("llama3_2_1b").smoke()
    r_params = jax.tree.map(np.asarray, r_reg.build_model(cfg).init(jax.random.PRNGKey(0)))
    params = convert.lm_from_reference(r_params, "cpu")
    got = t_ckpt.flatten_tree({"params": params, "opt": {"step": 3}})
    want = r_ckpt.flatten_tree({"params": r_params, "opt": {"step": np.int32(3)}})
    assert list(got) == list(want)
    assert "params/layers/attn/wq" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def _bf16_train_state(steps: int):
    """The reference's bf16 llama smoke model after ``steps`` train steps:
    (model, params, opt state) as the reference holds them."""
    cfg = r_base.get_config("llama3_2_1b").smoke().replace(dtype=jnp.bfloat16)
    model = r_reg.build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = r_tl.TrainConfig(optimizer=r_opt.AdamWConfig(lr=1e-3))
    state = r_tl.init_train_state(model, params, tcfg)
    step = jax.jit(r_tl.make_train_step(model, tcfg))
    for i in range(steps):
        params, state, _ = step(params, state,
                                r_reg.make_batch(cfg, batch=2, seq=8, seed=i))
    return model, params, state["opt"]


def _port_template(dtype=torch.bfloat16):
    cfg = t_base.get_config("llama3_2_1b").smoke().replace(dtype=dtype,
                                                           use_kernels=False)
    params = t_reg.build_model(cfg).init(1, "cpu")
    return {"params": params, "opt": t_opt.init_state(params)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    _, params, opt_state = _bf16_train_state(2)
    r_ckpt.CheckpointManager(str(tmp_path), async_write=False).save(
        2, {"params": params, "opt": opt_state})
    tree, step = CheckpointManager(str(tmp_path)).restore(_port_template())
    assert step == 2 and tree["opt"]["step"] == int(opt_state["step"]) == 2
    for name, got, want in (("params", tree["params"], params),
                            ("m", tree["opt"]["m"], opt_state["m"]),
                            ("v", tree["opt"]["v"], opt_state["v"])):
        want = convert.lm_from_reference(jax.tree.map(np.asarray, want), "cpu")
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            assert torch.equal(got[k], want[k]), (name, k)
    assert tree["params"]["embed"].dtype == torch.bfloat16
    assert tree["opt"]["m"]["embed"].dtype == torch.float32


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    template = _port_template()
    state = t_opt.init_state(template["params"])
    g = {k: torch.full_like(p, 0.5) for k, p in template["params"].items()}
    params, state, _ = t_opt.update(t_opt.AdamWConfig(), g, state, template["params"])
    CheckpointManager(str(tmp_path), async_write=False).save(
        4, {"params": params, "opt": state})
    model, r_params, r_opt_state = _bf16_train_state(0)
    tree, step = r_ckpt.CheckpointManager(str(tmp_path)).restore(
        {"params": r_params, "opt": r_opt_state})
    assert step == 4
    assert np.asarray(tree["opt"]["step"]).dtype == np.int32
    assert int(tree["opt"]["step"]) == state["step"] == 1
    for name, got, want in (("params", tree["params"], params),
                            ("m", tree["opt"]["m"], state["m"]),
                            ("v", tree["opt"]["v"], state["v"])):
        got = r_ckpt.flatten_tree(got)
        want = t_ckpt.flatten_tree(want)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].shape == want[k].shape, (name, k)
            assert got[k].tobytes() == want[k].tobytes(), (name, k)
    # the reference reads the port's bf16 words as the reference writes them
    assert tree["params"]["embed"].dtype == np.dtype("V2")


def test_manifest_marks_bf16(tmp_path):
    import json

    path = CheckpointManager(str(tmp_path), async_write=False).save(
        0, {"w": torch.ones(3, dtype=torch.bfloat16), "s": 2})
    with open(os.path.join(path, "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["w"]["dtype"] == "bfloat16" and arrays["s"]["dtype"] == "int32"


# -- fault tolerance ---------------------------------------------------------
class TestFaultTolerance:
    def test_watchdog_flags_stragglers(self):
        wd = Watchdog(threshold=2.0)
        for i in range(10):
            wd.observe(i, 1.0)
        assert not wd.straggler_steps
        assert wd.observe(10, 5.0)
        assert wd.straggler_steps == [10]

    def test_recovery_resumes_and_matches(self, tmp_path):
        def make_step(fail_at=None):
            calls = {"n": 0}

            def step_fn(step, state):
                if fail_at is not None and step == fail_at and calls["n"] < 1:
                    calls["n"] += 1
                    raise StepFailure("injected")
                return {"x": state["x"] + step}

            return step_fn

        finals = []
        for fail_at, sub in ((7, "a"), (None, "b")):
            ckpt = CheckpointManager(str(tmp_path / sub), async_write=False)
            final, rep = run_with_recovery(
                step_fn=make_step(fail_at), init_state={"x": np.zeros(3)},
                n_steps=12, ckpt=ckpt, save_every=3)
            assert rep["restarts"] == (fail_at is not None)
            finals.append(final["x"])
        np.testing.assert_array_equal(finals[0], finals[1])

    def test_too_many_failures_raises(self, tmp_path):
        def step_fn(step, state):
            raise StepFailure("always")

        ckpt = CheckpointManager(str(tmp_path), async_write=False)
        with pytest.raises(StepFailure):
            run_with_recovery(step_fn=step_fn, init_state={"x": 0}, n_steps=3,
                              ckpt=ckpt, max_restarts=2)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b"])
def test_crash_and_resume_is_bitwise_the_uninterrupted_run(arch, tmp_path):
    """``launch.train.train``: a StepFailure at step 6 restores step 4's
    checkpoint (async writes, keep 2) and replays; the final parameters
    and optimizer state equal an uninterrupted run's bit for bit."""
    cfg = t_base.get_config(arch).smoke().replace(use_kernels=False)
    tcfg = t_tl.TrainConfig(optimizer=t_opt.AdamWConfig(lr=3e-3, total_steps=10,
                                                        warmup_steps=1))
    fired = []

    def fail_once(step):
        if step == 6 and not fired:
            fired.append(step)
            raise StepFailure("injected")

    outs = []
    for sub, hook in (("crash", fail_once), ("clean", None)):
        outs.append(t_launch.train(
            cfg, tcfg, steps=10, batch=2, seq=16,
            ckpt=CheckpointManager(str(tmp_path / sub), keep=2), save_every=4,
            log_every=0, device="cpu", before_step=hook))
    crash, clean = outs
    assert crash["report"]["restarts"] == 1 and clean["report"]["restarts"] == 0
    assert len(crash["losses"]) == 10 + 1 and len(clean["losses"]) == 10
    assert clean["losses"][-1] < clean["losses"][0]
    for k, p in clean["params"].items():
        assert torch.equal(crash["params"][k], p), k
    for part in ("m", "v"):
        for k, t in clean["state"]["opt"][part].items():
            assert torch.equal(crash["state"]["opt"][part][k], t), (part, k)
    assert crash["state"]["opt"]["step"] == clean["state"]["opt"]["step"] == 10


def test_launch_train_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "10", "--log-every", "5", "--save-every", "3",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "use_kernels=False" in out.stdout
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("loss "))
    first, last = (float(v) for v in line.split(";")[0][5:].split(" -> "))
    assert np.isfinite([first, last]).all() and last < first
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 9
